"""Vectorized Riemann solvers for the compressible Euler module.

The reference computes fluxes with *scalar* Numba kernels called once per
interface from Python loops (v1_shock.py:301-306 — O(nx·ny) call overhead
per step). Here every solver takes whole left/right state *arrays* for one
sweep direction and returns the full face-flux array in one fused VPU pass.

State layout is component-leading: U has shape (4, ny, nx) with components
(ρ, ρu, ρv, ρE) so the trailing two axes are the grid's (y, x)
tiling. ``axis=1`` means x-faces (flux of F), ``axis=0`` y-faces (G).

Parity references: ``compute_fluxes`` v1_shock.py:84-95, ``hllc_solver``
v1_shock.py:147-209, ``roe_solver`` v1_shock.py:97-145,
``rusanov_riemann_solver_limited`` cavity_flow_v1.py:123-150.
"""

from __future__ import annotations

import jax.numpy as jnp


def cons_to_prim(U, gamma: float, eps: float = 1e-8, max_val: float = 1e3):
    """Primitive recovery with positivity floors and velocity clips
    (parity: v1_shock.py:84-89 floors/clips; cavity cons_to_prim_limited
    cavity_flow_v1.py:95-110)."""
    rho = jnp.maximum(U[0], eps)
    inv = 1.0 / rho
    u = jnp.clip(U[1] * inv, -max_val, max_val)
    v = jnp.clip(U[2] * inv, -max_val, max_val)
    E = jnp.clip(U[3] * inv, eps, max_val)
    p = jnp.maximum((gamma - 1.0) * rho * (E - 0.5 * (u * u + v * v)), eps)
    return rho, u, v, p


def prim_to_cons(rho, u, v, p, gamma: float):
    """(parity: prim_to_cons_stable cavity_flow_v1.py:431-443)."""
    E = p / ((gamma - 1.0) * rho) + 0.5 * (u * u + v * v)
    return jnp.stack([rho, rho * u, rho * v, rho * E])


def euler_flux(U, gamma: float, axis: int, eps: float = 1e-8, max_val: float = 1e3):
    """Physical flux along ``axis`` (1 = x → F, 0 = y → G)."""
    rho, u, v, p = cons_to_prim(U, gamma, eps, max_val)
    E = jnp.clip(U[3] / rho, eps, max_val)
    q = u if axis == 1 else v
    return jnp.stack(
        [
            rho * q,
            rho * u * q + (p if axis == 1 else 0.0),
            rho * v * q + (p if axis == 0 else 0.0),
            rho * q * (E + p / rho),
        ]
    )


def sound_speed(rho, p, gamma: float, eps: float = 1e-8):
    return jnp.sqrt(jnp.maximum(gamma * p / rho, eps))


def rusanov_flux(UL, UR, gamma: float, axis: int, eps: float = 1e-8,
                 max_val: float = 1e3):
    """Local Lax–Friedrichs: ½(F_L+F_R) − ½ λ_max ΔU
    (parity: cavity_flow_v1.py:123-150, vectorized over all faces)."""
    rL, uL, vL, pL = cons_to_prim(UL, gamma, eps, max_val)
    rR, uR, vR, pR = cons_to_prim(UR, gamma, eps, max_val)
    qL = uL if axis == 1 else vL
    qR = uR if axis == 1 else vR
    aL = sound_speed(rL, pL, gamma, eps)
    aR = sound_speed(rR, pR, gamma, eps)
    lam = jnp.maximum(jnp.abs(qL) + aL, jnp.abs(qR) + aR)
    FL = euler_flux(UL, gamma, axis, eps, max_val)
    FR = euler_flux(UR, gamma, axis, eps, max_val)
    return 0.5 * (FL + FR) - 0.5 * lam[None] * (UR - UL)


def hllc_flux(UL, UR, gamma: float, axis: int, eps: float = 1e-8,
              max_val: float = 1e3):
    """HLLC with star states, branch-free via nested ``jnp.where`` over the
    wave-speed sign pattern (parity: v1_shock.py:147-209; the scalar
    if-chains become masks)."""
    rL, uL, vL, pL = cons_to_prim(UL, gamma, eps, max_val)
    rR, uR, vR, pR = cons_to_prim(UR, gamma, eps, max_val)
    EL = jnp.clip(UL[3] / jnp.maximum(UL[0], eps), eps, max_val)
    ER = jnp.clip(UR[3] / jnp.maximum(UR[0], eps), eps, max_val)
    qL = uL if axis == 1 else vL
    qR = uR if axis == 1 else vR
    tL = vL if axis == 1 else uL  # tangential velocity
    tR = vR if axis == 1 else uR
    aL = sound_speed(rL, pL, gamma, eps)
    aR = sound_speed(rR, pR, gamma, eps)

    sL = jnp.minimum(qL - aL, qR - aR)
    sR = jnp.maximum(qL + aL, qR + aR)
    sM = (rR * qR * (sR - qR) - rL * qL * (sL - qL) + pL - pR) / (
        rR * (sR - qR) - rL * (sL - qL) + eps
    )

    FL = euler_flux(UL, gamma, axis, eps, max_val)
    FR = euler_flux(UR, gamma, axis, eps, max_val)

    def star(rho, q, s, E, p, tang):
        """Star-region conserved state behind wave speed s."""
        coef = rho * (s - q) / (s - sM + eps)
        p_star = rho * (q - s) * (q - sM) + p
        e_star = E + (p_star * sM - p * q) / (rho * (s - q) + eps)
        if axis == 1:
            mom_x, mom_y = coef * sM, coef * tang
        else:
            mom_x, mom_y = coef * tang, coef * sM
        return jnp.stack([coef, mom_x, mom_y, coef * e_star])

    UsL = star(rL, qL, sL, EL, pL, tL)
    UsR = star(rR, qR, sR, ER, pR, tR)
    F_star_L = FL + sL[None] * (UsL - UL)
    F_star_R = FR + sR[None] * (UsR - UR)

    flux = jnp.where(
        (sL >= 0)[None],
        FL,
        jnp.where(
            (sR <= 0)[None],
            FR,
            jnp.where((sM >= 0)[None], F_star_L, F_star_R),
        ),
    )
    return flux


def _roe_averages(UL, UR, gamma: float, eps: float, max_val: float):
    """Roe-averaged (ũ, ṽ, h̃, ã) plus the primitive L/R states."""
    rL, uL, vL, pL = cons_to_prim(UL, gamma, eps, max_val)
    rR, uR, vR, pR = cons_to_prim(UR, gamma, eps, max_val)
    hL = (UL[3] + pL) / jnp.maximum(UL[0], eps)
    hR = (UR[3] + pR) / jnp.maximum(UR[0], eps)
    wL = jnp.sqrt(rL)
    wR = jnp.sqrt(rR)
    norm = wL + wR + eps
    u_roe = (uL * wL + uR * wR) / norm
    v_roe = (vL * wL + vR * wR) / norm
    h_roe = (hL * wL + hR * wR) / norm
    a_roe = jnp.sqrt(
        jnp.maximum((gamma - 1.0) * (h_roe - 0.5 * (u_roe**2 + v_roe**2)), eps)
    )
    return (rL, uL, vL, pL), (rR, uR, vR, pR), (u_roe, v_roe, h_roe, a_roe), wL * wR


def roe_flux(UL, UR, gamma: float, axis: int, eps: float = 1e-8,
             max_val: float = 1e3):
    """Textbook Roe flux: full characteristic decomposition with the Harten
    entropy fix on the acoustic waves.

        F = ½(F_L + F_R) − ½ Σ_k α_k |λ_k| r_k

    with wave strengths α from the projection of ΔU onto the Roe-matrix
    eigenvectors (acoustic pair, entropy wave, shear wave) and
    |λ| → λ²/(2δ) + δ/2 for |λ| < δ = 0.1·ã on λ = q̃ ± ã (Harten 1983).
    This is the solver the reference's ``roe_solver`` (v1_shock.py:97-145)
    *intended* to be — its degenerate summed-eigenvalue variant is kept as
    ``"roe_ref"`` for parity."""
    (rL, uL, vL, pL), (rR, uR, vR, pR), (u_roe, v_roe, h_roe, a_roe), rho_roe_sq = (
        _roe_averages(UL, UR, gamma, eps, max_val)
    )
    # ρ̃ = √(ρ_L ρ_R)
    rho_roe = jnp.sqrt(jnp.maximum(rho_roe_sq, eps))
    if axis == 1:  # x-normal: q = u (normal), w = v (tangential)
        q_roe, w_roe = u_roe, v_roe
        dq, dw = uR - uL, vR - vL
    else:  # y-normal
        q_roe, w_roe = v_roe, u_roe
        dq, dw = vR - vL, uR - uL
    drho = rR - rL
    dp = pR - pL

    a2_inv = 1.0 / (a_roe * a_roe)
    alpha1 = 0.5 * (dp - rho_roe * a_roe * dq) * a2_inv  # q̃ − ã wave
    alpha2 = drho - dp * a2_inv  # entropy wave
    alpha3 = 0.5 * (dp + rho_roe * a_roe * dq) * a2_inv  # q̃ + ã wave
    alpha4 = rho_roe * dw  # shear wave

    def harten(lam):
        delta = 0.1 * a_roe
        return jnp.where(
            jnp.abs(lam) < delta, lam * lam / (2.0 * delta) + 0.5 * delta,
            jnp.abs(lam),
        )

    l1 = harten(q_roe - a_roe)
    l2 = jnp.abs(q_roe)
    l3 = harten(q_roe + a_roe)

    ke_roe = 0.5 * (u_roe * u_roe + v_roe * v_roe)
    if axis == 1:
        r1 = jnp.stack([jnp.ones_like(u_roe), u_roe - a_roe, v_roe,
                        h_roe - u_roe * a_roe])
        r3 = jnp.stack([jnp.ones_like(u_roe), u_roe + a_roe, v_roe,
                        h_roe + u_roe * a_roe])
        r4 = jnp.stack([jnp.zeros_like(u_roe), jnp.zeros_like(u_roe),
                        jnp.ones_like(u_roe), v_roe])
    else:
        r1 = jnp.stack([jnp.ones_like(u_roe), u_roe, v_roe - a_roe,
                        h_roe - v_roe * a_roe])
        r3 = jnp.stack([jnp.ones_like(u_roe), u_roe, v_roe + a_roe,
                        h_roe + v_roe * a_roe])
        r4 = jnp.stack([jnp.zeros_like(u_roe), jnp.ones_like(u_roe),
                        jnp.zeros_like(u_roe), u_roe])
    r2 = jnp.stack([jnp.ones_like(u_roe), u_roe, v_roe, ke_roe])

    diss = (
        (alpha1 * l1)[None] * r1
        + (alpha2 * l2)[None] * r2
        + (alpha3 * l3)[None] * r3
        + (alpha4 * l2)[None] * r4
    )
    FL = euler_flux(UL, gamma, axis, eps, max_val)
    FR = euler_flux(UR, gamma, axis, eps, max_val)
    return 0.5 * (FL + FR) - 0.5 * diss


def roe_ref_flux(UL, UR, gamma: float, axis: int, eps: float = 1e-8,
                 max_val: float = 1e3):
    """The reference's "roe" scheme (v1_shock.py:97-145): Roe-averaged
    velocities and sound speed with an entropy floor ε=0.05a, dissipating
    with the *sum* of the three entropy-fixed eigenvalues applied to ΔU —
    i.e. a heavily-dissipative Rusanov-like variant, reproduced for parity
    (see ``roe_flux`` for the textbook characteristic solver)."""
    rL, uL, vL, pL = cons_to_prim(UL, gamma, eps, max_val)
    rR, uR, vR, pR = cons_to_prim(UR, gamma, eps, max_val)
    hL = (UL[3] + pL) / jnp.maximum(UL[0], eps)
    hR = (UR[3] + pR) / jnp.maximum(UR[0], eps)

    wL = jnp.sqrt(rL)
    wR = jnp.sqrt(rR)
    norm = wL + wR + eps
    u_roe = (uL * wL + uR * wR) / norm
    v_roe = (vL * wL + vR * wR) / norm
    h_roe = (hL * wL + hR * wR) / norm
    a_roe = jnp.sqrt(
        jnp.maximum((gamma - 1.0) * (h_roe - 0.5 * (u_roe**2 + v_roe**2)), eps)
    )
    q = u_roe if axis == 1 else v_roe
    floor = 0.05 * a_roe
    l1 = jnp.maximum(floor, jnp.abs(q))
    l2 = jnp.maximum(floor, jnp.abs(q + a_roe))
    l3 = jnp.maximum(floor, jnp.abs(q - a_roe))

    FL = euler_flux(UL, gamma, axis, eps, max_val)
    FR = euler_flux(UR, gamma, axis, eps, max_val)
    return 0.5 * (FL + FR) - 0.5 * ((l1 + l2 + l3))[None] * (UR - UL)


FLUXES = {
    "rusanov": rusanov_flux,
    "hllc": hllc_flux,
    "roe": roe_flux,
    "roe_ref": roe_ref_flux,
}


# ---------------------------------------------------------------------------
# dimension-generic solvers (any number of velocity components) — the 3D
# extension the reference never had; the 2D solvers above stay untouched
# for parity, and the *_nd versions are tested to match them exactly in 2D
# ---------------------------------------------------------------------------

def cons_to_prim_nd(U, gamma: float, eps: float = 1e-8, max_val: float = 1e3):
    """Primitive recovery for U = (ρ, ρu_1..ρu_d, ρE): (ρ, [u_i], p)."""
    nv = U.shape[0] - 2
    rho = jnp.maximum(U[0], eps)
    inv = 1.0 / rho
    vels = [jnp.clip(U[1 + i] * inv, -max_val, max_val) for i in range(nv)]
    E = jnp.clip(U[-1] * inv, eps, max_val)
    ke = sum(w * w for w in vels) * 0.5
    p = jnp.maximum((gamma - 1.0) * rho * (E - ke), eps)
    return rho, vels, p


def euler_flux_nd(U, gamma: float, vaxis: int, eps: float = 1e-8,
                  max_val: float = 1e3):
    """Physical flux along velocity component ``vaxis`` (0-based)."""
    rho, vels, p = cons_to_prim_nd(U, gamma, eps, max_val)
    E = jnp.clip(U[-1] / rho, eps, max_val)
    q = vels[vaxis]
    comps = [rho * q]
    for i, w in enumerate(vels):
        comps.append(rho * w * q + (p if i == vaxis else 0.0))
    comps.append(rho * q * (E + p / rho))
    return jnp.stack(comps)


def rusanov_flux_nd(UL, UR, gamma: float, vaxis: int, eps: float = 1e-8,
                    max_val: float = 1e3):
    rL, vL, pL = cons_to_prim_nd(UL, gamma, eps, max_val)
    rR, vR, pR = cons_to_prim_nd(UR, gamma, eps, max_val)
    aL = sound_speed(rL, pL, gamma, eps)
    aR = sound_speed(rR, pR, gamma, eps)
    lam = jnp.maximum(jnp.abs(vL[vaxis]) + aL, jnp.abs(vR[vaxis]) + aR)
    FL = euler_flux_nd(UL, gamma, vaxis, eps, max_val)
    FR = euler_flux_nd(UR, gamma, vaxis, eps, max_val)
    return 0.5 * (FL + FR) - 0.5 * lam[None] * (UR - UL)


def hllc_flux_nd(UL, UR, gamma: float, vaxis: int, eps: float = 1e-8,
                 max_val: float = 1e3):
    """HLLC with star states for any velocity dimension: the normal
    component jumps to s_M in the star region, tangentials are advected
    (same structure as the validated 2D ``hllc_flux``)."""
    rL, vL, pL = cons_to_prim_nd(UL, gamma, eps, max_val)
    rR, vR, pR = cons_to_prim_nd(UR, gamma, eps, max_val)
    EL = jnp.clip(UL[-1] / jnp.maximum(UL[0], eps), eps, max_val)
    ER = jnp.clip(UR[-1] / jnp.maximum(UR[0], eps), eps, max_val)
    qL, qR = vL[vaxis], vR[vaxis]
    aL = sound_speed(rL, pL, gamma, eps)
    aR = sound_speed(rR, pR, gamma, eps)
    sL = jnp.minimum(qL - aL, qR - aR)
    sR = jnp.maximum(qL + aL, qR + aR)
    sM = (rR * qR * (sR - qR) - rL * qL * (sL - qL) + pL - pR) / (
        rR * (sR - qR) - rL * (sL - qL) + eps
    )
    FL = euler_flux_nd(UL, gamma, vaxis, eps, max_val)
    FR = euler_flux_nd(UR, gamma, vaxis, eps, max_val)

    def star(rho, q, s, E, p, vels):
        coef = rho * (s - q) / (s - sM + eps)
        p_star = rho * (q - s) * (q - sM) + p
        e_star = E + (p_star * sM - p * q) / (rho * (s - q) + eps)
        comps = [coef]
        for i, w in enumerate(vels):
            comps.append(coef * (sM if i == vaxis else w))
        comps.append(coef * e_star)
        return jnp.stack(comps)

    UsL = star(rL, qL, sL, EL, pL, vL)
    UsR = star(rR, qR, sR, ER, pR, vR)
    F_star_L = FL + sL[None] * (UsL - UL)
    F_star_R = FR + sR[None] * (UsR - UR)
    return jnp.where(
        (sL >= 0)[None],
        FL,
        jnp.where(
            (sR <= 0)[None],
            FR,
            jnp.where((sM >= 0)[None], F_star_L, F_star_R),
        ),
    )


def roe_flux_nd(UL, UR, gamma: float, vaxis: int, eps: float = 1e-8,
                max_val: float = 1e3):
    """Textbook Roe flux for any velocity dimension: characteristic
    decomposition (acoustic pair + entropy wave + D−1 shear waves) with
    the Harten entropy fix — the dimension-generic form of the validated
    2D ``roe_flux`` (reference intent: v1_shock.py:97-145)."""
    rL, vL, pL = cons_to_prim_nd(UL, gamma, eps, max_val)
    rR, vR, pR = cons_to_prim_nd(UR, gamma, eps, max_val)
    ndim = len(vL)
    wL = jnp.sqrt(jnp.maximum(rL, eps))
    wR = jnp.sqrt(jnp.maximum(rR, eps))
    inv_w = 1.0 / (wL + wR)
    v_roe = [(wL * vL[i] + wR * vR[i]) * inv_w for i in range(ndim)]
    EL = jnp.clip(UL[-1] / jnp.maximum(UL[0], eps), eps, max_val)
    ER = jnp.clip(UR[-1] / jnp.maximum(UR[0], eps), eps, max_val)
    hL = EL + pL / jnp.maximum(rL, eps)
    hR = ER + pR / jnp.maximum(rR, eps)
    h_roe = (wL * hL + wR * hR) * inv_w
    ke_roe = 0.5 * sum(c * c for c in v_roe)
    a_roe = jnp.sqrt(jnp.maximum((gamma - 1.0) * (h_roe - ke_roe), eps))
    rho_roe = wL * wR

    q_roe = v_roe[vaxis]
    dq = vR[vaxis] - vL[vaxis]
    drho = rR - rL
    dp = pR - pL
    a2_inv = 1.0 / (a_roe * a_roe)
    alpha1 = 0.5 * (dp - rho_roe * a_roe * dq) * a2_inv
    alpha2 = drho - dp * a2_inv
    alpha3 = 0.5 * (dp + rho_roe * a_roe * dq) * a2_inv

    def harten(lam):
        delta = 0.1 * a_roe
        return jnp.where(
            jnp.abs(lam) < delta, lam * lam / (2.0 * delta) + 0.5 * delta,
            jnp.abs(lam),
        )

    l1 = harten(q_roe - a_roe)
    l2 = jnp.abs(q_roe)
    l3 = harten(q_roe + a_roe)

    one = jnp.ones_like(q_roe)
    zero = jnp.zeros_like(q_roe)

    def eigvec(vel_normal, energy):
        return jnp.stack(
            [one]
            + [vel_normal if i == vaxis else v_roe[i] for i in range(ndim)]
            + [energy]
        )

    r1 = eigvec(q_roe - a_roe, h_roe - q_roe * a_roe)
    r3 = eigvec(q_roe + a_roe, h_roe + q_roe * a_roe)
    r2 = jnp.stack([one] + list(v_roe) + [ke_roe])
    diss = (
        (alpha1 * l1)[None] * r1
        + (alpha2 * l2)[None] * r2
        + (alpha3 * l3)[None] * r3
    )
    for i in range(ndim):
        if i == vaxis:
            continue
        alpha_s = rho_roe * (vR[i] - vL[i])
        r_s = jnp.stack(
            [zero] + [one if j == i else zero for j in range(ndim)] + [v_roe[i]]
        )
        diss = diss + (alpha_s * l2)[None] * r_s

    FL = euler_flux_nd(UL, gamma, vaxis, eps, max_val)
    FR = euler_flux_nd(UR, gamma, vaxis, eps, max_val)
    return 0.5 * (FL + FR) - 0.5 * diss


FLUXES_ND = {"rusanov": rusanov_flux_nd, "hllc": hllc_flux_nd,
             "roe": roe_flux_nd}
