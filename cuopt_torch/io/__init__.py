"""Input readers of the port: MPS files (`parse_mps`, the native parser
of cpp/mps_parser by default) and, in `vrp`, Solomon / CVRPLIB routing
instances and the synthetic Gehring-Homberger-class generator."""

from cuopt_torch.io.mps_parser import ParseMps, parse_mps
from cuopt_torch.io.native_mps import available as native_parser_available

__all__ = ["parse_mps", "ParseMps", "native_parser_available"]
