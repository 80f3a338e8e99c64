"""Distributed substrate — port of ``repro.distributed``: logical-axis
sharding rules and DTensor placements (``sharding``), the GPipe schedule
(``pipeline_parallel``), the supervisor's restart loop and straggler
policies (``fault_tolerance``) and the allocator's elastic replans
(``elastic``)."""
from . import sharding
