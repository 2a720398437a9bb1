"""Mean device time of the train step's ``grads`` part a step over the
window (the program's CUDA events, ``metrics["events"]["grads"]``)."""


def read(run):
    parts = [s["grads_ms"] for s in run.records.get("steps", [])
             if "grads_ms" in s]
    return sum(parts) / len(parts) if parts else None
