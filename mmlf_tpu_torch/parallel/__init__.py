"""Data parallelism of the port (``--mesh_data``): ``mesh`` holds the
process group, the rank's slice of a global batch and the collectives."""
