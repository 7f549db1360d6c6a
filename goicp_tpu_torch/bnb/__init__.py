from goicp_tpu_torch.bnb.fullcert import register_full_cert
from goicp_tpu_torch.bnb.params import BnbParams, GoIcpResult
from goicp_tpu_torch.bnb.solver import GoIcpSolver, make_solver, register

__all__ = ["BnbParams", "GoIcpResult", "GoIcpSolver", "make_solver", "register",
           "register_full_cert"]
