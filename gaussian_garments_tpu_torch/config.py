"""Configuration / flag system (the port's own copy of
``gaussian_garments_tpu/config.py``).

Reflective ``ParamGroup``s turn attributes into argparse flags (a leading
underscore adds the one-letter shorthand), and ``DEFAULTS`` is the path
registry, with the same flag names and default values as the reference
``arguments/__init__.py`` / ``utils/defaults.py``, so that command lines
written for the reference stage drivers work unchanged. ``data_device``
defaults to ``cuda``.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser
from types import SimpleNamespace


def _make_defaults() -> SimpleNamespace:
    return SimpleNamespace(
        output_root=os.environ.get("GG_OUTPUT_ROOT", "./output"),
        data_root=os.environ.get("GG_DATA_ROOT", "./data"),
        aux_root=os.environ.get("GG_AUX_ROOT", "./aux"),
        stage1="stage1",
        stage2="stage2",
        stage3="stage3",
        rgb_images="rgb_images",
        garment_masks="garment_masks",
        foreground_masks="foreground_masks",
        temp_folder=os.environ.get("GG_TEMP_FOLDER", "/tmp/gg_tpu"),
    )


DEFAULTS = _make_defaults()


class GroupParams:
    pass


class ParamGroup:
    """Reflective flag group: every attribute becomes ``--name`` (leading
    underscore also adds the one-letter shorthand)."""

    def __init__(self, parser: ArgumentParser, name: str, fill_none: bool = False):
        group = parser.add_argument_group(name)
        for key, value in vars(self).items():
            shorthand = key.startswith("_")
            if shorthand:
                key = key[1:]
            t = type(value)
            value = value if not fill_none else None
            flags = ["--" + key] + (["-" + key[0:1]] if shorthand else [])
            if t == bool:
                group.add_argument(*flags, default=value, action="store_true")
            elif t == list and not shorthand:
                group.add_argument(*flags, default=value, nargs="*")
            else:
                group.add_argument(*flags, default=value, type=t)

    def extract(self, args):
        group = GroupParams()
        for k, v in vars(args).items():
            if k in vars(self) or ("_" + k) in vars(self):
                setattr(group, k, v)
        return group


class ModelParams(ParamGroup):
    def __init__(self, parser, sentinel=False):
        self.sh_degree = 3
        self._resolution = -1
        self._white_background = False
        self.data_device = "cuda"
        self.eval = False
        self.llffhold = 12
        super().__init__(parser, "Loading Parameters", sentinel)


class PipelineParams(ParamGroup):
    def __init__(self, parser):
        self.convert_SHs_python = False
        self.compute_cov3D_python = False
        self.debug = False
        self.switch_to_D3G = False
        super().__init__(parser, "Pipeline Parameters")


class OptimizationParams(ParamGroup):
    def __init__(self, parser):
        self.iterations = None
        self.opt_opacity_from = None
        self.opt_mesh_from = None
        self.position_lr_init = 0.00016
        self.position_lr_final = 0.0000016
        self.position_lr_delay_mult = 0.01
        self.position_lr_max_steps = 30_000
        self.feature_lr = 0.0025
        self.opacity_lr = 0.05
        self.scaling_lr = 0.005
        self.rotation_lr = 0.001
        self.percent_dense = 0.01
        self.lambda_dssim = 0.2
        self.lambda_xyz = 1e-2
        self.threshold_xyz = 1.0
        self.lambda_scale = 1.0
        self.threshold_scale = 0.6
        self.recon_scale_threshold = 0.005
        self.lambda_color = 0.01
        self.lambda_bending = 0.03
        self.lambda_stretching = 0.01
        self.lambda_d3g = 0.001
        self.lambda_virtual = 0.05
        self.lambda_shs = 0.2
        self.threshold_opacity = 0.75
        self.lambda_opacity = 0.01
        self.lambda_inertial = 0.0
        self.lambda_gravity = 0.0
        self.lambda_collision = 1e3

        self.densification_interval = 100
        self.opacity_reset_interval = 3000
        self.densify_from_iter = 500
        self.densify_until_iter = 15_000
        self.densify_grad_threshold = 0.0002
        self.random_background = False

        self.only_foreground_loss = True
        super().__init__(parser, "Optimization Parameters")
