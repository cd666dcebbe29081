"""strict_fallback: the share of the window's queries that K2's count could
not prove exact and the index re-ran through the strict path, in percent
(TELEM's counter `flat.verify_fallback`; with integer distances, ties at
the k-th distance)."""


def read(run):
    if run.trace is None or not run.queries:
        return None
    return 100.0 * run.counters.get("flat.verify_fallback", 0) / run.queries
