"""api_host_ms: the Index API's time a call outside the scan, in ms: over
the window's calls that no query sent down the strict fallback (TELEM flag
`verify_fallback`), the mean of the call's wall less its `score_flat`
span. It holds the query's upload, the copies of the distances and ids to
the host, and the building of SearchResult lists; the strict fallback's
work is left to `strict_fallback`."""


def read(run):
    outside = [
        wall - stages["score_flat"] * 1e-3
        for wall, stages, flags in zip(run.call_s, run.stage_ms, run.flags)
        if "score_flat" in stages and "verify_fallback" not in flags
    ]
    if not outside:
        return None
    return sum(outside) / len(outside) * 1e3
