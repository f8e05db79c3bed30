"""Typed configuration of the port: the QP shape, the solver budget, the
time-allocation network, the losses and training, and the operating points
built from them.

Same fields and defaults as `allocnet_tpu/config.py`, so a configuration
carries over 1:1; the comments there give the reasons for each default.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QPConfig:
    """Shape and limits of the corridor-constrained min-snap/jerk QP."""

    order: int = 4          # 4 = min-snap (degree 7), 3 = min-jerk
    state_dim: int = 3      # boundary derivatives fixed at start/end (p, v, a)
    dim: int = 3
    res: int = 20           # constraint samples per segment
    max_seg: int = 5
    max_faces: int = 50
    max_vel: float = 4.0
    max_acc: float = 6.0

    @property
    def D(self) -> int:
        """Coefficients per segment per axis."""
        return 2 * self.order

    @property
    def n_var(self) -> int:
        return self.max_seg * self.dim * self.D

    @property
    def n_eq(self) -> int:
        return (2 * self.state_dim + self.order * (self.max_seg - 1)) * self.dim

    @property
    def n_corr(self) -> int:
        return self.max_seg * self.res * self.max_faces

    @property
    def n_box(self) -> int:
        return self.max_seg * self.res * 4 * self.dim

    @property
    def n_ineq(self) -> int:
        return self.n_corr + self.n_box


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Batched OSQP-style ADMM settings (see `allocnet_tpu/config.py`)."""

    sigma: float = 1e-6
    rho: float = 3.0
    rho_eq_scale: float = 100.0
    alpha: float = 1.6
    n_chunks: int = 3
    iters_per_chunk: int = 150
    polish: bool = True
    polish_rounds: int = 1
    max_active: int = 64
    polish_delta: float = 1e-7
    polish_refine_steps: int = 2
    # the reference's objective sanity window (qp_solver.hpp:340-345)
    obj_min: float = -0.01
    obj_max: float = 5000.0
    polish_dedup: bool = True
    polish_drop_passes: int = 0
    # "ldl" = pivot-free blocked LDL^T (ops/ldl.py); "lu" = pivoted LU
    polish_method: str = "ldl"
    polish_ldl_delta: float = 1e-5
    ns_rho_update: bool = True
    # run the ADMM chunks through the fused chunk kernel (ops/admm_chunk.py):
    # the hand-written CUDA kernel on a card, its plain version on the CPU.
    # The kernel is f32 only: on the CPU other dtypes (and False) take
    # admm.admm_solve; on a card they raise.
    use_pallas: bool = True
    # the TPU kernel's scenarios per grid step; the CUDA kernel runs one
    # scenario per block and does not read it (kept for config parity)
    pallas_tile: int = 16
    rho_scale_init: bool = True
    rho_scale_ref: float = 0.03
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Time-allocation network (reference: minsnap_network_conv*.py)."""

    seq_len: int = 5
    hidden_size: int = 256
    mlp_hidden: int = 128
    token_thresh: float = 0.42
    head: str = "lstm"
    use_time_factor: bool = False


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights (reference: minsnap_conv_lstm_params.yaml:40-44)."""

    w1: float = 17.5     # mean time-factor loss
    wt: float = 1200.0   # supervised time MSE fallback (unsolved QPs)
    wc: float = 0.1      # normalized QP cost
    wp: float = 20.0     # stop-token / padding loss
    end_penalty: float = 5.0


# Ablation operating point: supervised-time-only training, the QP gradient
# path switched off (reference train_minsnap_conv_mlp_as.py:135-139)
ABLATION_SUPERVISED = LossConfig(w1=0.0, wt=1.0, wc=0.0, wp=0.0)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    batch_size: int = 32
    t0: int = 500            # cosine warm restarts period
    t_mult: int = 2
    eta_min: float = 1e-5
    max_epochs: int = 50
    training_data_ratio: float = 0.9
    save_freq: int = 1
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class CorridorConfig:
    """Corridor generation (reference: sfc_gen.hpp, corridor_generator.py)."""

    # local cloud crop range and inflation progress per window
    # (sfc_gen::convexCover(range=7.0, progress=3.0))
    range_xy: float = 7.0
    progress: float = 3.0
    firi_iters: int = 4
    # RRT front end (rrt3D.py:25 maxiter, stepsize)
    rrt_max_iter: int = 5000
    rrt_step: float = 1.0
    rrt_goal_bias: float = 0.1
    safe_distance: float = 0.5
    # Informed RRT* (OMPL InformedRRTstar, sfc_gen.hpp:45-114) on the native
    # grid; the Python RRT is plain RRT.  A time budget of 0 bounds the
    # search by iterations only, so a seeded run is reproducible.
    use_rrt_star: bool = True
    rrt_star_time_budget: float = 0.0
    # iteration cap of the latency-bounded front end for mid-flight replans
    rrt_online_max_iter: int = 1000

    def online(self) -> "CorridorConfig":
        """The deterministic, iteration-bounded front end for 10 Hz
        replans."""
        return dataclasses.replace(self, rrt_max_iter=self.rrt_online_max_iter)


@dataclasses.dataclass(frozen=True)
class PhysParams:
    """Quadrotor physical parameters for the flatness map (planner.yaml:
    1-12)."""

    vehicle_mass: float = 0.61
    grav_acc: float = 9.81
    horiz_drag: float = 0.70
    vert_drag: float = 0.80
    parasitic_drag: float = 0.01
    speed_smooth: float = 0.001


@dataclasses.dataclass(frozen=True)
class AllocNetConfig:
    qp: QPConfig = dataclasses.field(default_factory=QPConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    corridor: CorridorConfig = dataclasses.field(default_factory=CorridorConfig)
    phys: PhysParams = dataclasses.field(default_factory=PhysParams)


# Deployment operating point (planner.yaml): order 4, res 20, v <= 4, a <= 6.
DEPLOY = AllocNetConfig()


# Training operating point (network configs): res 10, v <= 5, a <= 7.
TRAIN = AllocNetConfig(qp=QPConfig(order=4, res=10, max_vel=5.0, max_acc=7.0))

# Phase-1 training: the phase-1 box limits (params.yaml
# phase1_physical_limits) and times predicted as a factor over the
# per-segment lower bound, T_i = tlb_i * (1 + factor_i).
PHASE1 = AllocNetConfig(qp=QPConfig(order=4, res=10, max_vel=5.0, max_acc=8.0),
                        model=ModelConfig(use_time_factor=True))

# Offline certification budget: more ADMM iterations and active-set rounds
# for the degenerate corridors that stall at deploy settings.
CERTIFY_SOLVER = SolverConfig(n_chunks=4, iters_per_chunk=250,
                              polish_rounds=6, polish_drop_passes=1,
                              ns_rho_update=False)


def jerk(cfg: QPConfig) -> QPConfig:
    """The min-jerk variant of a QP shape (order 3, degree 5)."""
    return dataclasses.replace(cfg, order=3)
