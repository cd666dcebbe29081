"""strict_ms: the strict fallback's device time a call, in ms: the sum of
TELEM's `dev.strict` spans (CUDA events around the gather of the flagged
queries and `scan_topk_strict`) over the window's calls, over the calls.
Where K1 was timed (`dev.k1`) and no query fell back it reads 0; with no
device spans at all (off CUDA, or a program without them) nothing."""


def read(run):
    if not any("dev.k1" in stages for stages in run.stage_ms):
        return None
    return sum(stages.get("dev.strict", 0.0) for stages in run.stage_ms) / len(run.stage_ms)
