"""Window program: mean host milliseconds inside
``transcribe_window_async`` per window in the measured window, the host
work that pipelining must hide."""


def read(run):
    d = run.data.get("dispatch_ms")
    return sum(d) / len(d) if d else None
