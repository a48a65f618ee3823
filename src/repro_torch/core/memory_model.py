"""Cycle-approximate analytical model of the MANOJAVAM fabric.

Re-implements the paper's conservative simulator (Sec. VII-A): a worst-case
*sequential* dataflow where total time = data-loading overhead + systolic
compute cycles, with effective access time EAT = p*t_hit + (1-p)*penalty*t_hit
(p = 0.9, penalty = 10x) and the mode-aware write-miss policies of Sec. VI-B.

Also models the design space of Sec. VIII: execution time ~ M*N/(S*T^2),
power/resource scaling fitted to the two published design points
(Artix-7 (4,8) @ 200 MHz / 1.271 W and Virtex US+ (16,32) @ 434 MHz /
16.957 W; Tables I-III).

A copy of ``repro.core.memory_model`` (pure Python, no framework).  Every
number in it models the paper's FPGA fabric: the cycle counts, clock rates
and power figures are the paper's Artix-7 and Virtex UltraScale+ design
points.  None is a time measured on a TPU or on a CUDA card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    T: int = 16                 # tile size (systolic array edge)
    S: int = 32                 # parallelism index (number of arrays)
    freq_mhz: float = 434.0
    cache_hit: float = 0.9      # paper: p = 0.9
    dram_penalty: float = 10.0  # paper: 10x off-chip penalty
    # write-miss policies (Sec. VI-B): write-around makes covariance-phase
    # output stores bypass the cache (1 access, no fill); write-allocate
    # no-fetch-on-write makes rotation-phase read-modify-writes hit after
    # first touch.
    sweeps: int = 50


ARTIX7 = FabricConfig(T=4, S=8, freq_mhz=200.0)
VIRTEX_US = FabricConfig(T=16, S=32, freq_mhz=434.0)

# -- power / resource fits ---------------------------------------------------
# DSP count is exact from the paper: DSP = S*T^2/2 (two MACs per DSP48):
#   (4,8)  ->  64   (Table I)      (16,32) -> 4096  (Table II)
# Power: P = P0 + k * S*T^2 (MAC-array dynamic power dominates; Fig. 9):
#   1.271 = P0 + k*128 ; 16.957 = P0 + k*8192  =>  k ~ 1.945e-3, P0 ~ 1.022
_POWER_K = (16.957 - 1.271) / (32 * 16 ** 2 - 8 * 4 ** 2)
_POWER_0 = 1.271 - _POWER_K * 8 * 4 ** 2
# LUT/FF/BRAM linear fits through the two published points (vs S*T^2):
_LUT_K = (195814 - 9796) / (8192 - 128)
_LUT_0 = 9796 - _LUT_K * 128
_FF_K = (143777 - 23077) / (8192 - 128)
_FF_0 = 23077 - _FF_K * 128
_BRAM_K = (940.5 - 30.5) / (8192 - 128)
_BRAM_0 = 30.5 - _BRAM_K * 128


def power_w(cfg: FabricConfig) -> float:
    return _POWER_0 + _POWER_K * cfg.S * cfg.T ** 2


def resources(cfg: FabricConfig) -> Dict[str, float]:
    st2 = cfg.S * cfg.T ** 2
    return {
        "LUT": _LUT_0 + _LUT_K * st2,
        "FF": _FF_0 + _FF_K * st2,
        "BRAM": _BRAM_0 + _BRAM_K * st2,
        "DSP": st2 / 2,
    }


def _eat(cfg: FabricConfig) -> float:
    """Effective access time multiplier per burst cycle."""
    return cfg.cache_hit + (1.0 - cfg.cache_hit) * cfg.dram_penalty


def covariance_cycles(m: int, n: int, cfg: FabricConfig) -> float:
    """C = X^T X, X in R^{m x n}: block streaming over sample tiles.

    Output grid G x G (G = ceil(n/T)); each of the S arrays owns output
    tiles sequentially; every output tile accumulates K = ceil(m/T) tile
    products.  Per tile product (worst-case sequential, Sec. VII-A):
      * LHS tile burst load, T cycles * EAT, shared across the S arrays of a
        row-block group (one broadcast read serves S arrays: /S)
      * RHS tile burst load, T cycles * EAT, private per array
      * systolic compute: T stream cycles + (2T - 2) fill/drain
    Covariance-phase write-around: output stores stream out once, T cycles
    per tile row, no fill traffic.
    """
    g = math.ceil(n / cfg.T)
    k = math.ceil(m / cfg.T)
    passes = math.ceil(g * g / cfg.S)      # sequential output-tile rounds
    eat = _eat(cfg)
    per_tile = (cfg.T * eat) / cfg.S + cfg.T * eat + (3 * cfg.T - 2)
    store = cfg.T * eat                     # write-around stream-out per tile
    return passes * (k * per_tile + store)


def jacobi_cycles(n: int, cfg: FabricConfig, pivot: str = "cyclic") -> float:
    """Eigendecomposition cycles for an n x n covariance.

    Rotations are applied through the MM-Engine acting as a "parallel
    transformation engine that updates multiple rows and columns
    simultaneously" (Sec. VI-A): the S arrays x T lanes stream the 6
    touched vectors (2 rows + 2 cols of C, 2 cols of V) at S*T elements
    per cycle, while the 12n rotation MACs retire at S*T^2 per cycle.
    The pipelined CORDIC (depth ~32) is amortised to 1 cycle per rotation.
    Rotation-phase write-allocate no-fetch-on-write (Sec. VI-B): EAT
    applies to the 1/T fill fraction of row traffic.

      cyclic   -- the paper's Cyclic Jacobi schedule: no per-rotation scan
      paper    -- classical max-pivot: adds a DLE rescan per rotation,
                  streaming n^2 elements at S*T^2 per cycle (overlapped:
                  cost = max(scan, apply))
    """
    eat = _eat(cfg)
    bw = cfg.S * cfg.T              # streamed elements / cycle
    apply = 12 * n / (cfg.S * cfg.T ** 2) + 1
    row_traffic = (6 * n / bw) * (1 + (eat - 1) / cfg.T)
    per_rotation = max(apply, row_traffic)
    if pivot == "paper":
        scan = n * n / (cfg.S * cfg.T ** 2)
        per_rotation = max(per_rotation, scan)
    rotations = cfg.sweeps * n * (n - 1) // 2
    return rotations * per_rotation


def projection_cycles(m: int, n: int, k: int, cfg: FabricConfig) -> float:
    """O = X V_k: an m x n by n x k matmul on the same fabric."""
    g_m = math.ceil(m / cfg.T)
    g_k = math.ceil(k / cfg.T)
    kk = math.ceil(n / cfg.T)
    passes = math.ceil(g_m * g_k / cfg.S)
    eat = _eat(cfg)
    per_tile = (cfg.T * eat) / cfg.S + cfg.T * eat + (3 * cfg.T - 2)
    return passes * (kk * per_tile + cfg.T * eat)


def pca_seconds(m: int, n: int, cfg: FabricConfig, k: int = None,
                include_projection: bool = True) -> Dict[str, float]:
    """End-to-end PCA latency estimate, split by stage (paper Fig. 1/6)."""
    k = k or max(1, n // 4)
    f = cfg.freq_mhz * 1e6
    cov = covariance_cycles(m, n, cfg) / f
    svd = jacobi_cycles(n, cfg) / f
    proj = projection_cycles(m, n, k, cfg) / f if include_projection else 0.0
    total = cov + svd + proj
    return {"covariance_s": cov, "svd_s": svd, "projection_s": proj,
            "total_s": total, "energy_j": total * power_w(cfg)}
