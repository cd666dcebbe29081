"""results_ms: the Index API's building of SearchResult lists a call, in ms:
the mean of TELEM's `results` span (`FlatIndex._results`) over the window's
calls that have it."""


def read(run):
    spans = [stages["results"] for stages in run.stage_ms if "results" in stages]
    if not spans:
        return None
    return sum(spans) / len(spans)
