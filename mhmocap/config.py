"""Config / flag system: argparse + YAML merge, no `exec`.

Drop-in parity with the reference `mhmocap/config.py` (parse_args,
ConfigContext, args; config.py:14-106): the same CLI flags, the same
YAML layout (an `ARGS:` mapping merged into the namespace with CLI
precedence, plus optional `smpl:` / `data:` / `studio:` / `internet:`
sub-dicts attached as attributes), so the reference's configs/*.yml
files work unchanged. The reference merges YAML via exec() string
evaluation (config.py:59-62); this implementation uses plain setattr.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import yaml

PROJECT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Scene-Aware 3D Multi-Human Motion Capture")
    p.add_argument("-f", type=str, help="compat placeholder")
    p.add_argument("--configs_yml", type=str, default="configs/default.yml")
    p.add_argument("--ts_id", type=int, default=1)
    p.add_argument("--cam", type=int, default=0)
    p.add_argument("--cmu_sequence_id", type=str, default="")
    p.add_argument("--cmu_camera_node", type=int, default=16)
    p.add_argument("--cmu_clip_id", type=int, default=1)
    p.add_argument("--input_path", type=str, default="")
    p.add_argument("--output_path", type=str, default="./output")
    p.add_argument("--batch_size", type=int, default=4,
                   help="frames per scan chunk (reference: DataLoader "
                        "batch); also the temporal chunk size")
    p.add_argument("--resize_factor", type=float, default=0.25)
    p.add_argument("--num_iter", type=int, default=200)
    p.add_argument("--proj2d_loss_coef", type=float, default=1.0)
    p.add_argument("--depth_loss_coef", type=float, default=1.0)
    p.add_argument("--silhouette_loss_coef", type=float, default=1.0)
    p.add_argument("--reg_velocity_coef", type=float, default=1.0)
    p.add_argument("--reg_verts_filter_coef", type=float, default=1.0)
    p.add_argument("--reg_poses_coef", type=float, default=10.0)
    p.add_argument("--reg_scales_coef", type=float, default=10.0)
    p.add_argument("--reg_contact_coef", type=float, default=1.0)
    p.add_argument("--reg_foot_sliding_coef", type=float, default=1.0)
    return p


def parse_args(input_args: Optional[List[str]] = None):
    """Parse CLI args, then fill everything else from the YAML's ARGS
    mapping (CLI wins). Sub-dicts smpl/data/studio/internet become
    attributes, and --input_path overrides data['data_path']."""
    parser = _build_parser()
    parsed = parser.parse_args(args=input_args)

    yml = parsed.configs_yml
    if not os.path.isabs(yml):
        candidate = os.path.join(PROJECT_DIR, yml)
        yml = candidate if os.path.exists(candidate) else yml
    with open(yml) as f:
        updates = yaml.full_load(f)

    given = set()
    for arg in (input_args or []):
        if isinstance(arg, str) and arg.startswith("--"):
            given.add(arg[2:].split("=")[0])

    for key, value in (updates.get("ARGS") or {}).items():
        if key in given:
            continue
        setattr(parsed, key, value)

    for group in ("smpl", "data", "studio", "internet"):
        if group in updates:
            setattr(parsed, group, updates[group])

    if "data" in updates and parsed.input_path:
        parsed.data["data_path"] = parsed.input_path

    return parsed


class ConfigContext:
    """Context manager holding the active configuration (reference
    config.py:82-103 parity; no temp files needed)."""

    parsed_args = None

    def __init__(self, parsed_args=None):
        if parsed_args is not None:
            ConfigContext.parsed_args = parsed_args
        elif ConfigContext.parsed_args is None:
            ConfigContext.parsed_args = parse_args(sys.argv[1:])

    def __enter__(self):
        return ConfigContext.parsed_args

    def __exit__(self, exc_type, exc_val, exc_tb):
        pass


def args():
    return ConfigContext.parsed_args
