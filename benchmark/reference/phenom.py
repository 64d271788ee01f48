"""The detector error model of a phenomenological memory experiment, built
directly as matrices (numpy, dense 0/1 uint8).

A code's checks ``H`` (m x n) are measured in ``rounds`` rounds. Detector
``r * m + c`` is check c's change in round r. The error mechanisms, in
this column order, round by round:

- a data flip of bit j in round r (prior ``p``): it flips that round's
  detectors of j's checks, and the observable where ``logical`` holds j;
- below the last round, which is perfect, a measurement flip of check c in
  round r (prior ``q``): it flips check c's detectors in rounds r and r + 1.

No two mechanisms flip the same detectors, so none merge. The same model is
given behind stim's instruction interface (:class:`StimLikeDem`:
``flattened``, ``num_detectors``, ``num_observables``), for a program that
converts a DEM itself; stim is not needed.
"""

from typing import NamedTuple

import numpy as np

from benchmark.reference import codes


class Phenom(NamedTuple):
    H: np.ndarray  # (rounds * m, N) uint8 detectors x mechanisms
    obs: np.ndarray  # (1, N) uint8 the observable's row
    priors: np.ndarray  # (N,) float64
    num_checks: int


def surface_logical(d: int) -> np.ndarray:
    """A logical of the unrotated surface code's ``hx`` that commutes with
    its Z checks: the d bits (2, 0..d-1) of the first block's d x d grid.
    At d = 13 it is row 0 of ``surface_code(13).lx`` in the port, the
    observable of the port's own overlapping-window runs (a CPU test holds
    them equal); at other distances that row is another row of the grid."""
    x = np.zeros(d * d + (d - 1) * (d - 1), np.uint8)
    x[2 * d : 3 * d] = 1
    return x


def mechanisms(H: np.ndarray, logical: np.ndarray, rounds: int):
    """The columns as ``(detectors, observable flip)``, in the model's order."""
    m, n = H.shape
    checks = [np.flatnonzero(H[:, j]) for j in range(n)]
    for r in range(rounds):
        for j in range(n):
            yield [r * m + int(c) for c in checks[j]], int(logical[j]), "data"
        if r < rounds - 1:
            for c in range(m):
                yield [r * m + c, (r + 1) * m + c], 0, "measurement"


def build(H: np.ndarray, logical: np.ndarray, rounds: int, p: float, q: float) -> Phenom:
    m, _ = H.shape
    cols = list(mechanisms(H, logical, rounds))
    D = np.zeros((rounds * m, len(cols)), np.uint8)
    obs = np.zeros((1, len(cols)), np.uint8)
    priors = np.empty(len(cols), np.float64)
    for k, (dets, flip, kind) in enumerate(cols):
        D[dets, k] = 1
        obs[0, k] = flip
        priors[k] = p if kind == "data" else q
    return Phenom(D, obs, priors, m)


def surface_memory(d: int, rounds: int, p: float, q: float) -> Phenom:
    """The memory experiment of the unrotated surface code of distance
    ``d`` (``codes.build``) with the observable :func:`surface_logical`."""
    return build(codes.build({"family": "surface", "distance": d}), surface_logical(d),
                 rounds, p, q)


class _Target:
    def __init__(self, val: int, observable: bool = False):
        self.val, self._observable = val, observable

    def is_relative_detector_id(self) -> bool:
        return not self._observable

    def is_logical_observable_id(self) -> bool:
        return self._observable

    def is_separator(self) -> bool:
        return False


class _Error:
    type = "error"

    def __init__(self, prob: float, targets: list):
        self._prob, self._targets = prob, targets

    def args_copy(self) -> list:
        return [self._prob]

    def targets_copy(self) -> list:
        return self._targets


class StimLikeDem:
    """The model as stim's ``DetectorErrorModel`` instructions: one
    ``error(prior)`` a mechanism, its detectors then its observable, in the
    matrices' column order."""

    def __init__(self, H: np.ndarray, logical: np.ndarray, rounds: int, p: float, q: float):
        m, _ = H.shape
        self.num_detectors, self.num_observables, self.num_checks = rounds * m, 1, m
        self._errors = [
            _Error(p if kind == "data" else q,
                   [_Target(t) for t in dets] + [_Target(0, True)] * flip)
            for dets, flip, kind in mechanisms(H, logical, rounds)]

    def flattened(self) -> list:
        return self._errors

    @classmethod
    def surface_memory(cls, d: int, rounds: int, p: float, q: float) -> "StimLikeDem":
        return cls(codes.build({"family": "surface", "distance": d}), surface_logical(d),
                   rounds, p, q)
