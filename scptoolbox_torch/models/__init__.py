"""Bundled benchmark problems (reference test/examples/*): each module
builds a TrajectoryProblem (or a direct ConicProgram for the LCvx examples)
plus a solve entry point. As in the JAX package, the problem functions are
re-exported under their modules' names, so a module whose name is taken
is reached with `importlib.import_module`."""

from scptoolbox_torch.models.double_integrator import (
    DoubleIntegratorParameters, double_integrator)
from scptoolbox_torch.models.freeflyer import FreeFlyerParameters, freeflyer
from scptoolbox_torch.models.oscillator import (OscillatorParameters,
                                                oscillator, solve_oscillator)
from scptoolbox_torch.models.quadrotor import QuadrotorParameters, quadrotor
from scptoolbox_torch.models.rendezvous_3d import (Rendezvous3DParameters,
                                                   rendezvous_3d,
                                                   solve_rendezvous_3d)
from scptoolbox_torch.models.rendezvous_planar import (
    PlanarRendezvousParameters, rendezvous_planar, solve_rendezvous_planar)
from scptoolbox_torch.models.rocket_landing import Rocket, solve_lcvx
from scptoolbox_torch.models.starship_flip import StarshipParameters, starship

__all__ = [
    "DoubleIntegratorParameters", "double_integrator",
    "FreeFlyerParameters", "freeflyer",
    "OscillatorParameters", "oscillator", "solve_oscillator",
    "QuadrotorParameters", "quadrotor",
    "Rendezvous3DParameters", "rendezvous_3d", "solve_rendezvous_3d",
    "PlanarRendezvousParameters", "rendezvous_planar",
    "solve_rendezvous_planar",
    "Rocket", "solve_lcvx",
    "StarshipParameters", "starship",
]
