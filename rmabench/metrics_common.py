"""What several metric readers share."""


def idle_percent(run):
    """100 × (1 - device busy / traced window), or ``None`` untraced."""
    tr = run.tr
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def mean_ms(spans):
    """Mean length of ``(start, end)`` host spans in ms, or ``None``."""
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
