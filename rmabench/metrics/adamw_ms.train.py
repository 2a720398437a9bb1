"""Mean device time of the train step's ``adamw`` part a step over the
window (the program's CUDA events, ``metrics["events"]["adamw"]``)."""


def read(run):
    parts = [s["adamw_ms"] for s in run.records.get("steps", [])
             if "adamw_ms" in s]
    return sum(parts) / len(parts) if parts else None
