"""Distribution of the PyTorch port over ``torch.distributed``: the
logical-axis rules, parameter specs and batch split (``sharding``),
context-parallel decode (``context_parallel``), the mesh-trained DLRM's
checkpoint through one writer (``checkpoint``) and gradient compression
(``compression``); the mesh is ``repro_torch.launch.mesh``."""
