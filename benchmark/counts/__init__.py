"""The operations and bytes each kernel's roofline counts, from the
cell's own inputs."""
