"""scan_self_ms: the time a call's scan span holds outside K1 and K2, in
ms: over the window's calls with device spans, the mean of TELEM's
`score_flat` less `dev.k1` and `dev.k2` (CUDA events around each kernel's
launch). It holds the kernels' input ops, the top-k between them, the
`exact` reduction, the launch gaps and the copy of the flags."""


def read(run):
    own = [stages["score_flat"] - stages["dev.k1"] - stages["dev.k2"]
           for stages in run.stage_ms if {"score_flat", "dev.k1", "dev.k2"} <= stages.keys()]
    if not own:
        return None
    return sum(own) / len(own)
