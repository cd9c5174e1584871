"""Hyper-parameters (the port's own copy of ``PatchMatchParams``,
``PriorConfig``, ``FusionParams`` and ``PipelineConfig`` of
acmmp_spherical_tpu/config.py).

Every field keeps the reference's name and default, so parameters built on
either side convert with ``PatchMatchParams(**dataclasses.asdict(other))``
(``interop.params``).  Knobs whose code paths are not ported yet are kept as
fields; the pass raises ``NotImplementedError`` on them
(``ops/propagate._check_params``).  The bf16 packs (``rect_tap_pack``,
``rect_backmap_pack``) are TPU gather levers the port does not implement: it
samples taps and maps costs back in f32 whatever they say.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PatchMatchParams:
    """Per-pass PatchMatch hyper-parameters (reference ACMMP.h:32-55 plus the
    constants inlined in ACMMP.cu / main.cpp)."""

    # core schedule (ACMMP.h:33-40)
    max_iterations: int = 3          # photometric; geom passes force 2
    patch_size: int = 11             # NCC window
    radius_increment: int = 2        # NCC tap stride -> 6x6 = 36 taps
    sigma_spatial: float = 5.0       # bilateral spatial sigma, px
    sigma_color: float = 3.0         # bilateral colour sigma
    top_k: int = 4                   # views aggregated in the initial cost
    max_image_size: int = 3200       # long-side cap

    # working depth range (set per problem; ACMMP.cpp:645-646)
    depth_min: float = 0.0
    depth_max: float = 1.0

    # mode flags (ACMMP.h:50-54)
    geom_consistency: bool = False
    planar_prior: bool = False
    multi_geometry: bool = False
    hierarchy: bool = False

    # propagation / view selection constants (ACMMP.cu)
    num_votes: int = 15
    view_prior_selected: float = 0.9
    view_prior_unselected: float = 0.1
    cost_threshold_base: float = 0.8
    cost_threshold_anneal: float = 90.0
    view_weight_beta: float = 0.18
    view_fallback_beta: float = 0.32
    bad_cost: float = 1.2
    max_bad_views: int = 3
    min_good_candidates: int = 2
    geom_weight_prop: float = 0.2    # geom cost weight in propagation
    geom_weight_refine: float = 0.1  # geom cost weight in refinement
    geom_max_cost: float = 3.0       # geometric consistency clamp
    cost_max: float = 2.0            # NCC cost clamp

    # refinement (ACMMP.cu:797-936)
    refine_perturbation: float = 0.02

    # cost-evaluation paths (see the reference config for each knob)
    fast_ncc: bool = False
    exact_first_iteration: bool = False
    rect_ncc: bool = False
    rect_comp_hw: "tuple[int, int] | None" = None
    rect_live_n: "int | None" = None
    rect_warp_hw: "tuple[int, int] | None" = None
    sphere_live_n: "int | None" = None
    rect_init: bool = False
    rect_win_w: int = 384
    rect_init_win: int = 384
    rect_prescreen: bool = False
    prescreen_increment: int = 5
    rect_tap_pack: bool = True
    rect_backmap_pack: bool = True
    rect_inv_attrib: bool = False

    # planar prior model (ACMMP.cu:818-824, 1249-1255)
    prior_gamma: float = 0.5
    prior_beta: float = 0.18
    prior_angle_sigma_deg: float = 5.0
    prior_depth_sigma_div: float = 64.0
    prior_init_perturbation: float = 0.02

    # hierarchy (ACMMP.cu:713-779, 1315-1320)
    hierarchy_commit_margin: float = 0.1
    jbu_sigma_spatial: float = 0.5
    jbu_sigma_range: float = 25.5

    # median filter (ACMMP.cu:1366-1480)
    filter_min_cost: float = 0.001

    @property
    def prior_angle_sigma(self) -> float:
        return math.pi * self.prior_angle_sigma_deg / 180.0

    def with_geom(self, multi_geometry: bool) -> "PatchMatchParams":
        """SetGeomConsistencyParams (reference ACMMP.cpp:548-555)."""
        return dataclasses.replace(self, geom_consistency=True,
                                   max_iterations=2,
                                   multi_geometry=multi_geometry)

    def with_hierarchy(self) -> "PatchMatchParams":
        return dataclasses.replace(self, hierarchy=True)

    def with_planar_prior(self) -> "PatchMatchParams":
        return dataclasses.replace(self, planar_prior=True)

    def with_depth_range(self, dmin: float, dmax: float) -> "PatchMatchParams":
        return dataclasses.replace(self, depth_min=float(dmin),
                                   depth_max=float(dmax))


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    """Planar-prior construction (host side; reference ACMMP.cpp:904-1011)."""

    cell_size: int = 5               # support-point grid
    support_cost_threshold: float = 0.1


@dataclasses.dataclass(frozen=True)
class FusionParams:
    """Fusion thresholds of the reference's GPU path (ACMMP.cu:1758-1778)."""

    max_reproj_error: float = 1.0
    max_rel_depth_diff: float = 0.01
    max_normal_angle: float = 0.149  # radians
    min_consistent: int = 3          # including the reference view itself
    max_src_views: int = 32          # FusionProblem cap (ACMMP.cu:1659)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Coarse-to-fine pipeline settings (reference main.cpp:392-482).

    ``fast_ncc`` / ``rect_ncc``: "auto" turns the windowed / rectified
    kernel path on when the pipeline runs on a CUDA device (the windowed
    one for pinhole problems; the rectified one per problem, for pinhole
    problems that pass ``host_rectifiable`` and SPHERE ones that pass
    ``sphere_rectifiable``), "on", "off".  ``rect_unify`` is the scene-wide rect-kernel settings
    tuple of ``pass_runner.compute_scene_rect_settings``, set per scale by
    ``run_pipeline`` (None: each problem derives its own)."""

    patchmatch: PatchMatchParams = PatchMatchParams()
    prior: PriorConfig = PriorConfig()
    fusion: FusionParams = FusionParams()

    size_bound: int = 1000           # pyramid coarsest bound (main.cpp:38)
    geom_iterations: int = 2         # geometric passes per scale (main.cpp:412)
    depth_min_scale: float = 0.6     # working range padding (ACMMP.cpp:645-646)
    depth_max_scale: float = 1.2
    planar_prior: bool = True        # run the prior-assisted second round
    fast_ncc: str = "auto"
    rect_ncc: str = "auto"
    seed: int = 0                    # global RNG seed
    max_src_views: int = 20          # pad/truncate source views per problem
    skip_if_complete: bool = False   # resume: skip passes in the manifest
    rect_unify: "tuple | None" = None
