"""The distributed layer: logical sharding rules and per-family spec
tables (``sharding``, ``rules``, as ``repro.parallel``), and the explicit
collectives the SPMD ranks run over a mesh's axes (``collectives``)."""
