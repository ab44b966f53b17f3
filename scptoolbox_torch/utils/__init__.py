"""Math and utility functions (the reference's src/utils/). Importing this
package imports no matplotlib: the plotting modules import it at their
first plot."""

from scptoolbox_torch.utils import quaternion
from scptoolbox_torch.utils.geometry import (
    Ellipsoid,
    Hyperrectangle,
    skew,
    homtransf,
    hominv,
    homdisp,
    homrot,
)
from scptoolbox_torch.utils.interp import (
    linterp,
    zohinterp,
    diracinterp,
    straightline_interpolate,
)
from scptoolbox_torch.utils.integrate import rk4, rk4_grid, trapz, grad_trapz
from scptoolbox_torch.utils.smooth import (
    logsumexp,
    sigmoid,
    indicator,
    smooth_or,
    Homotopy,
)
from scptoolbox_torch.utils.search import golden
from scptoolbox_torch.utils.tree import TreeNode, find_common
from scptoolbox_torch.utils.checkpoint import (load_solution, load_state,
                                               save_solution, save_state)
from scptoolbox_torch.utils.linsys import c2d_zoh, c2d_foh
from scptoolbox_torch.utils.trajectory import ContinuousTimeTrajectory, sample

__all__ = [
    "quaternion",
    "Ellipsoid",
    "Hyperrectangle",
    "skew",
    "homtransf",
    "hominv",
    "homdisp",
    "homrot",
    "linterp",
    "zohinterp",
    "diracinterp",
    "straightline_interpolate",
    "rk4",
    "rk4_grid",
    "trapz",
    "grad_trapz",
    "logsumexp",
    "sigmoid",
    "indicator",
    "smooth_or",
    "Homotopy",
    "golden",
    "TreeNode",
    "find_common",
    "load_solution",
    "load_state",
    "save_solution",
    "save_state",
    "c2d_zoh",
    "c2d_foh",
    "ContinuousTimeTrajectory",
    "sample",
]
