"""Launch-layer pieces of the port (``repro.launch``'s twins).

    mesh   - the port's ``Mesh``: abstract production meshes and live ones
             over ``torch.distributed`` process groups (``make_dev_mesh``);
    shapes - the 40 dry-run cells (``SHAPES``, ``make_cell``,
             ``batch_specs`` as meta-device tensors);
    hlo    - the regex parser of collective ops in HLO text, which
             ``repro_torch.trace.hlo_to_trace`` replays;
    steps  - ``make_train_step`` (autograd loss, gradient accumulation,
             AdamW), ``accum_for``, ``make_prefill_step`` and
             ``make_decode_step``;
    train  - the fault-tolerant training entry point and its CLI.
Not in the port yet: the dry run (``steps.make_case``, ``dryrun``,
``probe``, ``report``, ``hillclimb``), which lowers to XLA HLO against TPU
roofline constants in the reference and waits for its torch analogue
(ROADMAP Queue 1 item 6).
"""
