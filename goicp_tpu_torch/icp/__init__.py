from goicp_tpu_torch.icp.solver import (
    IcpParams,
    IcpResult,
    exact_correspondence,
    run_icp,
)

__all__ = ["IcpParams", "IcpResult", "exact_correspondence", "run_icp"]
