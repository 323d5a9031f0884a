"""Host milliseconds per fault scenario in the fault and routing work: the
reachability walks, the repair spec and the topology builds (the repaired
twin's re-routing), synchronised on exit."""

NAMES = ("sim._fault_reachability", "repair.suggest_repair_morph",
         "spec.TopologySpec.build")


def read(run):
    scenarios = run["calls"].get("repair.measure_repair", 0)
    if not scenarios:
        return None
    return 1e3 * sum(run["span_s"].get(n, 0.0) for n in NAMES) / scenarios
