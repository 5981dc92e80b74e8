from .formats import (
    dataset_factory, read_cam, read_dpt, read_flow, read_flow_kitti,
    read_gen, read_pfm, write_flow,
)
from .tartan import TartanAirDataset

__all__ = [
    "TartanAirDataset", "dataset_factory", "read_cam", "read_dpt",
    "read_flow", "read_flow_kitti", "read_gen", "read_pfm", "write_flow",
]
