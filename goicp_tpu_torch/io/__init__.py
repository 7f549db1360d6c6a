from goicp_tpu_torch.io.loader import load_cloud
from goicp_tpu_torch.io.ply import read_ply, write_ply
from goicp_tpu_torch.io.txt import read_txt, write_txt
from goicp_tpu_torch.io.writer import write_result_toml

__all__ = ["load_cloud", "read_ply", "write_ply", "read_txt", "write_txt",
           "write_result_toml"]
