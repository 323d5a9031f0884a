"""Percent of the noc_step kernel's cycle loop that its CTAs spend waiting
at barriers: the SM cycles that thread 0 of each CTA counted inside the
loop's barriers over the cycles of its whole loop, summed over every CTA
of every launch of the traced window's ``spans`` and ``profiled``
requests (``noc_step.clock`` kernel records; the CPU's twin has none)."""


def read(run):
    clocks = [cta for k in run.get("program_kernels", ())
              if k["name"] == "noc_step.clock" and k["clock"] is not None
              for point in k["clock"] for cta in point]
    loop = sum(c[1] for c in clocks)
    if not loop:
        return None
    return 100.0 * sum(c[0] for c in clocks) / loop
