"""Host ms per request in ``pack_batch`` (RCM, the block-aligned layout),
timed by the benchmark's shim around the call ``Predictor.predict`` makes
(packing layer)."""


def read(run):
    spans = run.spans.get("pack_batch", [])
    if run.unit != "request" or not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
