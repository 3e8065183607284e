"""D2A core in PyTorch: compiler IR, e-graph flexible matching, ILA
formalism, code generation and application-level co-simulation."""
