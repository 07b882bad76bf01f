"""Physical constants of the reference (SI from ``scipy.constants``, the
CODATA tables the upstream RaJePy uses; cgs derived here)."""
import math

import scipy.constants as sc

C, H, K_B, G = sc.c, sc.h, sc.k, sc.G
E_CHARGE, M_E, EPSILON_0, U_AMU = sc.e, sc.m_e, sc.epsilon_0, sc.u
RYDBERG, AU, PARSEC, YEAR = sc.Rydberg, sc.au, sc.parsec, sc.year
MSOL = 1.98847e30                         # solar mass [kg]
C_CGS, H_CGS, K_CGS = C * 1e2, H * 1e7, K_B * 1e7
AU2CM = AU * 1e2

# (Z, N) and AME2012 masses [micro-u] of the two elements the cells use
NZ = {'H': (1, 0), 'He': (2, 2)}
MASS_MICRO_U = {'H': 1007825.03207, 'He': 4002603.25415}


def atomic_mass(atom: str) -> float:
    """Mass of ``atom`` [kg]."""
    return MASS_MICRO_U[atom] * 1e-6 * U_AMU


def z_number(atom: str) -> int:
    return NZ[atom][0]


# Rydberg energy of an infinite-mass nucleus [J]: the van Hoof table's axis
RY_INF = M_E * E_CHARGE ** 4 / (8.0 * EPSILON_0 ** 2 * H ** 2)
LN2 = math.log(2.0)
