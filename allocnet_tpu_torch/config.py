"""Typed configuration of the port: the QP shape, the solver budget and the
time-allocation network.

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


# Offline certification budget: more ADMM iterations and active-set rounds
# for the degenerate corridors that stall at deploy settings.
CERTIFY_SOLVER = SolverConfig(n_chunks=4, iters_per_chunk=250,
                              polish_rounds=6, polish_drop_passes=1,
                              ns_rho_update=False)
