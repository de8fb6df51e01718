"""The host's time to issue a served request: the median over the
window's requests of the benchmark's own span from the request's first
call into the program until its last call returns, before the wait."""
LAYER = "serving"


def read(run):
    from benchmark.metrics._shares import median_ms
    return median_ms(run.window.get("issue_s", []))
