"""Launch-layer pieces of the port (``repro.launch``'s twins).

    mesh      - the port's ``Mesh``: abstract production meshes, live ones
                over ``torch.distributed`` process groups
                (``make_dev_mesh``) and the dry run's simulated world
                (``make_fake_mesh`` / ``destroy_fake_mesh``: PyTorch's
                ``"fake"`` process group, process-global state);
    shapes    - the 40 dry-run cells (``SHAPES``, ``make_cell``,
                ``batch_specs`` as meta-device tensors);
    hlo       - the regex parser of collective ops in HLO text, which
                ``repro_torch.trace.hlo_to_trace`` replays;
    steps     - ``make_train_step`` (autograd loss, gradient
                accumulation, AdamW), ``accum_for``, ``make_prefill_step``,
                ``make_decode_step`` and ``make_case`` (a cell's step with
                its arguments as DTensors on a live mesh);
    census    - the dry run's counts (a ``TorchDispatchMode``: per-device
                FLOPs, eager bytes, peak live bytes, collectives);
    dryrun    - the sweep over the cells and meshes (``run_cell``,
                ``roofline_terms``, the CLI), no card needed;
    probe     - the per-stage breakdown (``corrected_costs``);
    report    - the records' tables;
    hillclimb - the three climbs, ``climb_collective`` among them;
    train     - the fault-tolerant training entry point and its CLI.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
        --shape all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.report
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell collective

``chip_smoke.py`` phase 21 runs the dry run on the card's fake CUDA
tensors and holds it to real one-card runs.
"""
