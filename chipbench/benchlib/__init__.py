"""The benchmark's own library: discovery of cells from files, seeded
weights and traffic, the FLOP and byte formulas, the trace reduction and the
plain reference that decides ``correct``."""
