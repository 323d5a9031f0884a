"""The plain reference of the NoC path: NumPy and plain torch, frozen from
the port's plain code and importing nothing of it.  ``noc.grid`` and
``noc.repair`` work a request out again from the generator's dicts."""
