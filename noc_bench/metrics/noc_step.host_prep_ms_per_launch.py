"""Host milliseconds of ``run_fused``'s work before each kernel launch
(the program's ``noc_step.prepare`` span: input checks, the cluster
plan, the kernel's layout and the route remap), per launch, over the
traced window's ``spans`` requests."""
from noc_bench import program_trace


def read(run):
    spent = program_trace.span_ms(run, "noc_step.prepare")
    return sum(spent) / len(spent) if spent else None
