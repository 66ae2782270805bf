"""Device ms of one decode step's graph replay: the device-busy time
inside the traced steps' replay spans, over the steps traced."""


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.spans("decode")
    if not spans:
        return None
    return run.trace.device_s_within(spans) / len(spans) * 1e3
