from goicp_tpu_torch.icp.solver import (
    IcpParams,
    IcpResult,
    exact_correspondence,
    grid_correspondence,
    run_icp,
    run_icp_trace,
    sse_of_distances,
    trim_weights,
)

__all__ = [
    "IcpParams", "IcpResult", "exact_correspondence", "grid_correspondence",
    "run_icp", "run_icp_trace", "sse_of_distances", "trim_weights",
]
