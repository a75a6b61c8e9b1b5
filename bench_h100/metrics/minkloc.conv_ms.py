"""``minkloc.conv_ms`` (ms): device time a batch of MinkLoc3Dv2's
convolution stages: conv0, each level's stride-2 conv and block, the two
top-down steps, each with its BN, ReLU, ECA, residual and laterals (spans
``minkloc/conv0``, ``minkloc/down_{i}``, ``minkloc/block_{i}``,
``minkloc/up_{j}``), from the eager forwards ``embed_sparse`` profiles
after a traced window (the window's graph replays open no span)."""

SPANS = ("minkloc/conv0", *(f"minkloc/{part}_{i}" for part in ("down", "block")
                            for i in range(4)), "minkloc/up_0", "minkloc/up_1")


def read(obs):
    spans = (obs.counters or {}).get("span_ms")
    if not spans:
        return None
    ms = sum(spans.get(name, 0.0) for name in SPANS)
    return ms if ms > 0 else None
