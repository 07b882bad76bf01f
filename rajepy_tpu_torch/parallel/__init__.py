"""Multi-device execution: LOS and channel sharding of the RT products,
the grid fill, the tile and epoch paths and cube imaging
(:mod:`.sharding`), and the run fan-out of the pipeline (:mod:`.fanout`).
One process drives a list of devices; see :mod:`.sharding`."""
