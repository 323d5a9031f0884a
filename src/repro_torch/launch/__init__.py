"""Launch-layer pieces of the port (``repro.launch``'s twins).

    hlo   — the regex parser of collective ops in HLO text, which
            ``repro_torch.trace.hlo_to_trace`` replays;
    steps — ``make_train_step`` (autograd loss, gradient accumulation,
            AdamW) and ``accum_for``;
    train — the fault-tolerant training driver and its CLI.
The rest of the reference's launch layer (mesh, dry-run cases, roofline)
is not in the port yet.
"""
