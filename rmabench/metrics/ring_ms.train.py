"""Mean device time of the train step's ``sync`` part a step over the
window (the program's CUDA events, ``metrics["events"]["sync"]``)."""


def read(run):
    parts = [s["sync_ms"] for s in run.records.get("steps", [])
             if "sync_ms" in s]
    return sum(parts) / len(parts) if parts else None
