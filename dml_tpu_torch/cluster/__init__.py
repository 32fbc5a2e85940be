"""Cluster control plane: transport, membership, election, store (the
port's copy of dml_tpu/cluster/, plain Python; the chaos harness is
ROADMAP A6(b))."""
