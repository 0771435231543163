"""Targets answered in the window (without an error) over its seconds:
the rate the deployment served, host and card together (host clock, at
the load generator). On this host the host pipeline sets it, and it
spreads too widely between runs to hold a bound, so it is read per layer."""


def read(rec):
    done = [s for s in rec.window.answered_in_window()
            if s.req.error is None]
    return len(done) / rec.window.seconds
