"""Launch-layer pieces of the port (``repro.launch``'s twins).

    hlo — the regex parser of collective ops in HLO text, which
          ``repro_torch.trace.hlo_to_trace`` replays.  The rest of the
          reference's launch layer (mesh, dry runs, roofline) is not in
          the port yet.
"""
