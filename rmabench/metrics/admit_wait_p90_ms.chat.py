"""The wait inside an admission: for each traced prefill, from the end of
the scheduler's selection that picked its request (the program's
``sched.select`` span, ``picked``) to the start of its prefill (its
``serve.prefill`` span), 90th percentile over the traced prefills.  It is
the wait behind prefills admitted before it in the same admission."""
from rmabench import stats
from rmabench.program_spans import spans


def read(run):
    selects = sorted((s.t1, s.attrs.get("picked", ()))
                     for s in spans(run, "sched.select"))
    waits = []
    for p in spans(run, "serve.prefill"):
        ends = [t1 for t1, picked in selects
                if t1 <= p.t0 and p.attrs.get("rid") in picked]
        if ends:
            waits.append(p.t0 - ends[-1])
    return 1e3 * stats.percentile(waits, 90) if waits else None
