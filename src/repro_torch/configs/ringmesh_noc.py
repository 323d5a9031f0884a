"""The paper's own artifact: Ring-Mesh NoC experiment configuration
(§7 experimental grid), expressed against the port's declarative
experiment API (``core.spec`` / ``core.traffic`` / ``core.experiment``).
``chip_smoke.py`` drives it on the card.  The reference config's
resilience and trace grids (``resilience_experiments``,
``trace_experiments``) are not in the port's config yet."""
import dataclasses

from repro_torch.core import traffic
from repro_torch.core.experiment import Budget, Experiment
from repro_torch.core.spec import TopologySpec


@dataclasses.dataclass(frozen=True)
class NoCExperimentConfig:
    sizes: tuple = (16, 32, 64, 128, 256, 512, 1024)
    patterns: tuple = ("uniform", "bit_reversal", "transpose")
    injection_rates: tuple = (0.25, 0.50, 0.75, 1.00)
    cycles: int = 1500
    warmup: int = 500
    queue_depth: int = 2        # paper: 2 VCs per input port
    src_queue_depth: int = 8
    # paper operating regime (§1/§3): most traffic confined to rings
    locality_ringlet: float = 0.75
    locality_block: float = 0.20

    # -- declarative views --------------------------------------------------
    def topology_spec(self, family: str, n_pes: int) -> TopologySpec:
        return TopologySpec(family=family, n_pes=n_pes,
                            queue_depth=self.queue_depth,
                            src_queue_depth=self.src_queue_depth)

    def budget(self, backend: str = "cuda", device=None) -> Budget:
        return Budget(cycles=self.cycles, warmup=self.warmup,
                      backend=backend, device=device)

    def traffic_specs(self) -> tuple:
        """The §7 patterns under the paper's locality-heavy regime."""
        return tuple(
            traffic.spec(p, locality_ringlet=self.locality_ringlet,
                         locality_block=self.locality_block)
            for p in self.patterns)

    def experiments(self, sizes=None,
                    families=("ring_mesh", "flat_mesh"),
                    seed: int = 1, backend: str = "cuda",
                    device=None) -> list[Experiment]:
        """The full §7 grid as Experiment objects — run them with
        ``experiment.run_experiments`` (one launch per geometry)."""
        budget = self.budget(backend, device)
        traffics = self.traffic_specs()
        return [
            Experiment(topology=self.topology_spec(f, n), traffic=t,
                       budget=budget, inj_rate=ir, seed=seed)
            for n in (sizes if sizes is not None else self.sizes)
            for f in families
            for ir in self.injection_rates
            for t in traffics
        ]


CONFIG = NoCExperimentConfig()
