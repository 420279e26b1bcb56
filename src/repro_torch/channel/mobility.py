"""Vehicle mobility (Eqs. 3-4): constant eastbound velocity, RSU at origin
with antennas at height H.  Positions are a pure function of time.

Two geometries live here:

- :class:`Mobility` — the paper's world: one RSU, coverage-wrap re-entry.
- :class:`CorridorMobility` — the multi-RSU highway corridor (DESIGN.md
  §8/§10): ``n_rsus`` segments of width ``2*coverage``, RSU j at the center
  of segment j, hard handover at segment edges, wrap-around re-entry at the
  corridor ends.  Every method is vectorized over vehicles *and* times
  (positions are a pure function of time, so whole trajectories fall out of
  one broadcast expression) — the corridor engine and its host planner both
  read this geometry, so there is exactly one definition of "which RSU
  serves vehicle i at time t".
"""
from __future__ import annotations

import numpy as np

from repro_torch.channel.params import ChannelParams


class Mobility:
    """Tracks K vehicles.  x_i(t) = x_i(0) + v t (Eq. 3), with wrap-around
    re-entry at the coverage edge (the paper keeps K vehicles under the RSU;
    re-entry keeps the population constant — documented in DESIGN.md)."""

    def __init__(self, params: ChannelParams, x0: np.ndarray | None = None):
        self.p = params
        if x0 is None:
            # spread vehicles across the western half of the coverage
            x0 = -params.coverage + (2 * params.coverage) * (
                np.arange(params.K) / params.K)
        self.x0 = np.asarray(x0, np.float64)

    def position(self, i: int, t: float) -> np.ndarray:
        """P^i(t) = (d_x, d_y, 0), Eq. (3), with coverage wrap."""
        span = 2 * self.p.coverage
        dx = self.x0[i] + self.p.v * t
        dx = ((dx + self.p.coverage) % span) - self.p.coverage
        return np.array([dx, self.p.d_y, 0.0])

    def distance(self, i: int, t: float) -> float:
        """d^i(t) = || P^i(t) - P_R ||, Eq. (4), P_R = (0, 0, H)."""
        pos = self.position(i, t)
        ref = np.array([0.0, 0.0, self.p.H])
        return float(np.linalg.norm(pos - ref))

    def distances(self, t) -> np.ndarray:
        """All K distances to the RSU at time(s) ``t`` (vectorized Eq. 4,
        same wrap as :meth:`position`).  The selection layer scores whole
        fleets at one decision instant, so it reads this instead of K
        scalar :meth:`distance` calls."""
        span = 2 * self.p.coverage
        dx = self.x0 + self.p.v * np.asarray(t)
        dx = ((dx + self.p.coverage) % span) - self.p.coverage
        return np.sqrt(dx ** 2 + self.p.d_y ** 2 + self.p.H ** 2)

    def next_boundary_crossing(self, i, t):
        """Earliest time ``> t`` at which vehicle ``i`` reaches the coverage
        edge (= its wrap-around re-entry).  Broadcasts — the single-RSU
        counterpart of :meth:`CorridorMobility.next_boundary_crossing`, so
        the selection layer's predicted-residence-time feature reads one
        interface on either geometry."""
        span = 2 * self.p.coverage
        dx = self.x0[np.asarray(i)] + self.p.v * np.asarray(t)
        into = (dx + self.p.coverage) % span
        return np.asarray(t) + (span - into) / self.p.v


class CorridorMobility:
    """Vehicle kinematics along an ``n_rsus``-segment highway corridor.

    RSU j sits at the center of segment j (width ``2*coverage``); a vehicle
    is served by the RSU whose segment contains it (hard handover at segment
    edges), wrapping at the corridor ends so the population stays constant —
    the same re-entry convention as the single-RSU :class:`Mobility`.

    ``i`` and ``t`` may be scalars or arrays and broadcast together, so
    ``serving_rsu(np.arange(K), t)`` is the whole fleet's cell assignment in
    one expression (the public, vectorized promotion of the ad-hoc
    per-vehicle ``_Corridor`` helper the serial handover loop used).

    ``entry`` picks the initial placement when ``x0`` is not given:

    - ``"uniform"`` — spread over the whole corridor (steady-state traffic).
    - ``"rush"``    — the whole fleet packed into the westmost segment, so a
      density wave of platoons enters at one end and propagates east (the
      ``corridor-rush-hour-*`` scenarios).
    """

    def __init__(self, params: ChannelParams, n_rsus: int,
                 x0: np.ndarray | None = None, entry: str = "uniform"):
        self.p = params
        self.n_rsus = n_rsus
        self.span = 2 * params.coverage * n_rsus
        self.cell = 2 * params.coverage
        self.centers = (-self.span / 2
                        + (np.arange(n_rsus) + 0.5) * self.cell)
        if x0 is None:
            frac = np.arange(params.K) / params.K
            if entry == "uniform":
                x0 = -self.span / 2 + self.span * frac
            elif entry == "rush":
                x0 = -self.span / 2 + self.cell * frac
            else:
                raise ValueError(
                    f"unknown entry profile {entry!r}; "
                    "expected 'uniform' or 'rush'")
        self.x0 = np.asarray(x0, np.float64)

    def x(self, i, t):
        """Corridor position of vehicle(s) ``i`` at time(s) ``t`` (Eq. 3
        with corridor wrap).  Broadcasts ``i`` against ``t``."""
        dx = self.x0[np.asarray(i)] + self.p.v * np.asarray(t)
        return ((dx + self.span / 2) % self.span) - self.span / 2

    def serving_rsu(self, i, t):
        """Index of the RSU whose segment contains vehicle ``i`` at ``t``
        (hard handover at segment edges).  Broadcasts; integer-valued."""
        j = ((self.x(i, t) + self.span / 2) // self.cell).astype(np.int64)
        return np.clip(j, 0, self.n_rsus - 1)

    def distance(self, i, t):
        """Distance to the *serving* RSU's antenna (Eq. 4 with the corridor
        serving-cell geometry).  Broadcasts."""
        x = self.x(i, t)
        j = self.serving_rsu(i, t)
        return np.sqrt((x - self.centers[j]) ** 2
                       + self.p.d_y ** 2 + self.p.H ** 2)

    def distances(self, t) -> np.ndarray:
        """All K distances to each vehicle's serving RSU at time(s) ``t``
        (the corridor counterpart of :meth:`Mobility.distances`)."""
        return self.distance(np.arange(self.p.K), t)

    def positions(self, t):
        """All K corridor positions at time(s) ``t``: shape ``[K]`` (or
        ``t.shape + [K]`` for an array of times)."""
        t = np.asarray(t)
        return self.x(np.arange(self.p.K), t[..., None] if t.ndim else t)

    def serving_cells(self, t):
        """All K serving-RSU indices at time(s) ``t``."""
        t = np.asarray(t)
        return self.serving_rsu(np.arange(self.p.K),
                                t[..., None] if t.ndim else t)

    def next_boundary_crossing(self, i, t):
        """Earliest time ``> t`` at which vehicle ``i`` crosses a segment
        boundary (= its next handover or corridor re-entry).  Broadcasts.

        Vehicles move east at constant ``v``, so the crossing is when the
        offset into the current segment reaches the segment width."""
        into = (self.x(i, t) + self.span / 2) % self.cell
        return np.asarray(t) + (self.cell - into) / self.p.v
