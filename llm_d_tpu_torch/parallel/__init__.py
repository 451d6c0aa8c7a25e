"""Parallel layer of the port: the mesh of ranks and its collectives
(``mesh``), starting the ranks (``launch``), the sharding rules
(``sharding``), the quantized collectives and their byte models
(``quant_collectives``), and expert-parallel load balancing (``eplb``)."""
