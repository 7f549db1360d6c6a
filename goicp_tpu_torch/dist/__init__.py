"""Distribution (port of the JAX package's ``dist/``): the (cubes × points)
device mesh of one process (:mod:`~goicp_tpu_torch.dist.sharding`, the mesh
rounds of :mod:`~goicp_tpu_torch.dist.se3`) and the frontier-sharded solve
across processes (:class:`GoIcpSolverMultiHost`, loaded lazily)."""

from goicp_tpu_torch.dist.sharding import (
    Mesh,
    make_mesh,
    sharded_bounds_step,
    sharded_evaluate_se3,
    sharded_icp_step,
    sharded_sse,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "sharded_evaluate_se3",
    "sharded_bounds_step",
    "sharded_icp_step",
    "sharded_sse",
    "GoIcpSolverMultiHost",
]


def __getattr__(name):
    # lazy: the multi-process engine pulls in torch.distributed, which
    # single-process users never need
    if name == "GoIcpSolverMultiHost":
        from goicp_tpu_torch.dist.multihost import GoIcpSolverMultiHost

        return GoIcpSolverMultiHost
    raise AttributeError(name)
