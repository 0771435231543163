"""Host-to-device bytes a batch, in MB (10^6 bytes): Pack's
``bytes_shipped`` (the store's slot maps and miss rows plus the
adjacency) over the batches Pack made in the window."""


def read(rec):
    packs = rec.delta("packs")
    if packs <= 0:
        return None
    return rec.delta("bytes_shipped") / packs / 1e6
