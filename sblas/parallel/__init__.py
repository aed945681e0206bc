"""Multi-device distribution (layer L3, SURVEY.md C10/C11).

The reference's multi-GPU runtime is an OpenMP thread per GPU with P2P
copies/unified memory as transport and device+thread barriers as sync.
Here the library owns no transport at all: partitions come from
``sblas.partition``, placement is `jax.sharding.NamedSharding` over a 1D
`Mesh('chips')`, and the collectives (`all_gather` of x, `psum` of partial
y, per-level exchange in SpTRSV) are emitted by XLA from
`shard_map`-annotated code, which on GPUs it hands to NCCL.

The cards of one host are joined all to all, so the mesh follows the
algorithm, not a physical topology. Develop and test on a CPU mesh via
XLA_FLAGS=--xla_force_host_platform_device_count=N; the same code runs on
the GPUs of one host.

Multi-host: after `jax.distributed.initialize()`, `jax.devices()` spans all
hosts. The flat plans work unchanged on a global mesh, but the hierarchical
('hosts', 'chips') plans (`sblas.parallel.hier`) split every collective by
mesh axis — all_gather over 'chips' stays within a host, the once-per-host
hop over 'hosts' crosses the network. Prefer those (or the 2D/halo plans,
whose per-device collective bytes shrink with the mesh) across hosts.
"""

from .mesh import (make_mesh, make_mesh2d, chips_axis, rows_axis, cols_axis,
                   hosts_axis)
from .spmv_dist import DistSpmvPlan, RingSpmvPlan, dist_spmv
from .spmv_halo import HaloSpmvPlan, HaloSpmmPlan, halo_spmv, halo_spmm
from .spmv2d import Dist2DSpmvPlan, dist_spmv2d
from .spmm2d import Dist2DSpmmPlan, dist_spmm2d
from .spmm_dist import DistSpmmPlan, dist_spmm
from .sptrsv_dist import DistSptrsvPlan, dist_sptrsv
from .sptrsm_dist import DistSptrsmPlan, dist_sptrsm
from .hier import HierSpmvPlan, HierSpmmPlan, make_mesh_hier
from .solvers_dist import dist_cg, dist_bicgstab, dist_gmres

__all__ = [
    "make_mesh", "make_mesh2d", "chips_axis", "rows_axis", "cols_axis",
    "hosts_axis", "HierSpmvPlan", "HierSpmmPlan", "make_mesh_hier",
    "DistSpmvPlan", "RingSpmvPlan", "dist_spmv",
    "HaloSpmvPlan", "halo_spmv", "HaloSpmmPlan", "halo_spmm",
    "Dist2DSpmvPlan", "dist_spmv2d",
    "Dist2DSpmmPlan", "dist_spmm2d",
    "DistSpmmPlan", "dist_spmm",
    "DistSptrsvPlan", "dist_sptrsv",
    "DistSptrsmPlan", "dist_sptrsm",
    "dist_cg", "dist_bicgstab", "dist_gmres",
]
