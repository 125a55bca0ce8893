"""Distribution of the PyTorch port over ``torch.distributed``: the
logical-axis rules and parameter specs (``sharding``) and context-parallel
decode (``context_parallel``); the mesh is ``repro_torch.launch.mesh``."""
