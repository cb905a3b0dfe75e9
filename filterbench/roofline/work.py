"""The work of the quadrature function "moments -> rule" at a call's
shapes, frozen here so that the yardstick does not move with the
program: operations and bytes of the function, whatever implements it.

- 1D, order n: ``k1_flops(n)`` operations a trial (the fused 1D
  quadrature's count: equilibration, LDL, Golub-Welsch coefficients,
  Sturm bisection and Newton for the nodes, Christoffel weights); bytes:
  the 2n moments, the mean and the scale read, n weights and n nodes
  written.
- ND, basis size s in d dimensions: the equilibrated LDL of the Gram
  (``ldl_flops``), the d operators K_m (``ksolve_flops``), d symmetric
  s x s eigendecompositions at 9 s^3 each (eigenvalues and eigenvectors
  by the symmetric QR algorithm, Golub & Van Loan, Matrix Computations,
  4th ed., sec. 8.3), the d - 1 cross products of eigenvector sets
  (2 s^3 each) and 2 d operations a node to form weights and nodes;
  bytes: the z moments and d means read, s^d nodes of d coordinates and
  s^d weights written.

Every value is f64 (8 bytes).
"""
import json
from pathlib import Path

F64 = 8


def k1_flops(n: int) -> int:
    equil = 2 * n + (n - 1)
    ldl = sum((n - j) * (3 * j + 2) + (n - j - 1) for j in range(n))
    gw = 2 * (n - 1) + 3 * (n - 1)
    back = 2 * n * (n - 1) // 2 + n + 1
    qform = 3 * n * (n + 1) // 2 + n * (n - 1) // 2
    gersh = 6 * n + 4
    sturm = 1 + 3 * (n - 1)
    bisect = n * 32 * (2 + sturm)
    newton = n * 8 * (8 * n + 2)
    weights = n * (2 + 7 * (n - 1) + 1 + 2)
    return equil + ldl + gw + back + qform + gersh + bisect + newton + weights


def ldl_flops(s: int) -> int:
    equil = 2 * s + s * (s + 1)
    return equil + sum(j + 2 * j + 3 + (s - 1 - j) * (2 * j + 1) for j in range(s))


def ksolve_flops(s: int, d: int) -> int:
    first = s * s * (s - 1)
    second = (s - 1) * s * (s + 1) // 3
    return d * (2 * s * s + first + second + 2 * s * (s + 1))


def eigh_flops(s: int) -> int:
    return 9 * s**3


def quadrature_1d_work(n: int, batch: int) -> dict:
    return {"flops": k1_flops(n) * batch, "bytes": (4 * n + 2) * F64 * batch}


def quadrature_nd_work(s: int, d: int, z: int, batch: int) -> dict:
    per_trial = (ldl_flops(s) + ksolve_flops(s, d) + d * eigh_flops(s)
                 + (d - 1) * 2 * s**3 + 2 * d * s**d)
    return {"flops": per_trial * batch, "bytes": ((z + d) + s**d * (d + 1)) * F64 * batch}


def peaks() -> dict:
    return json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def least_seconds(work: dict) -> float:
    """The larger of operations over the FP64 tensor-core peak and bytes
    over the HBM bandwidth."""
    p = peaks()
    return max(work["flops"] / p["fp64_tensor_core_flop_per_s"],
               work["bytes"] / p["hbm_bytes_per_s"])
