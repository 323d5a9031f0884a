"""Arbitration passes per simulated cycle and point: the passes that each
launch reports for each point (``noc_step.passes`` kernel records, both
backends) over the points' cycles, over the traced window's ``spans``
and ``profiled`` requests.  One is the least a cycle needs."""


def read(run):
    recs = [k for k in run.get("program_kernels", ())
            if k["name"] == "noc_step.passes"]
    cycles = sum(len(k["passes"]) * k["cycles"] for k in recs)
    if not cycles:
        return None
    return sum(sum(k["passes"]) for k in recs) / cycles
