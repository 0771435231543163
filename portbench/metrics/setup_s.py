"""Process start to the first timed request: graph and weights made,
kernels built or loaded, the server started and the traffic's ``fill``
top-ranked targets served once (host clock)."""


def read(rec):
    return rec.setup_s
