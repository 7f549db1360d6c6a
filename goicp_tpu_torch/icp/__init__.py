from goicp_tpu_torch.icp.solver import (
    IcpParams,
    IcpResult,
    exact_correspondence,
    run_icp,
    sse_of_distances,
    trim_weights,
)

__all__ = [
    "IcpParams", "IcpResult", "exact_correspondence", "run_icp",
    "sse_of_distances", "trim_weights",
]
