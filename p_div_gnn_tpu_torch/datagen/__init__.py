"""Synthetic plate-with-hole meshes, the divergence operator and the
flagship training workload."""
