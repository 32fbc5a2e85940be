"""Cluster control plane: transport, membership, election, store and
the chaos harness (the port's copy of dml_tpu/cluster/, plain Python)."""
