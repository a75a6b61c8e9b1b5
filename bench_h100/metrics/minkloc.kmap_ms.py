"""``minkloc.kmap_ms`` (ms): device time a batch of MinkLoc3Dv2's voxels and
kernel maps: the voxel keys and their ``unique`` at every stride, and every
map of the forward (spans ``minkloc/voxelize`` and ``minkloc/kmap``), from
the eager forwards ``embed_sparse`` profiles after a traced window (the
window's graph replays open no span)."""

SPANS = ("minkloc/voxelize", "minkloc/kmap")


def read(obs):
    spans = (obs.counters or {}).get("span_ms")
    if not spans:
        return None
    ms = sum(spans.get(name, 0.0) for name in SPANS)
    return ms if ms > 0 else None
