"""The benchmark of the port's NoC path (``repro_torch``); see README.md."""
