"""The share of the SBR parse cache's lookups over the window that found a
parsed payload (`BatchDecoder._sbr_parse_cache`, keyed by the payload's
bytes), counted by the benchmark's stand-in for the cache (routes/he.py).
Distinct stations repeat no payload within the cache's 513 entries, so a
hit here is a repeat the traffic was meant not to have."""


def read(run):
    lookups = run.counted("sbr_cache_lookups")
    if not lookups:
        return None
    return 100.0 * run.counted("sbr_cache_hits") / lookups
