"""Synthetic plate-with-hole meshes."""
