"""The port's remaining utils, the subproblem helpers and the package
exports against the JAX package's, on seeded numpy inputs on the CPU.

Numerics (interpolation, trajectories, RK4, grad_trapz, expm_diff, the
layout's extract and the quadratic-epigraph SOC rows) are held at 1e-12 in
float64; the tree, the checkpoint files (read by the other package both
ways, then a warm resume), the 3-D scene's numeric outputs and the plot
suites' line data (Agg) must be equal; the three `__all__` lists are
JAX's; importing the port builds nothing and imports no matplotlib."""

import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

import scptoolbox_torch  # noqa: E402
import scptoolbox_tpu  # noqa: E402
from scptoolbox_torch import models as tmodels  # noqa: E402
from scptoolbox_torch import utils as tutils  # noqa: E402
from scptoolbox_torch.config import SCPStatus  # noqa: E402
from scptoolbox_torch.solvers import ptr as tptr  # noqa: E402
from scptoolbox_torch.solvers import solution as tsolution  # noqa: E402
from scptoolbox_torch.solvers import subproblem as tsub  # noqa: E402
from scptoolbox_torch.utils import checkpoint as tckpt  # noqa: E402
from scptoolbox_torch.utils import example_plots as tep  # noqa: E402
from scptoolbox_torch.utils import geometry as tgeo  # noqa: E402
from scptoolbox_torch.utils import integrate as tint  # noqa: E402
from scptoolbox_torch.utils import interp as tinterp  # noqa: E402
from scptoolbox_torch.utils import linsys as tlin  # noqa: E402
from scptoolbox_torch.utils import plots as tplots  # noqa: E402
from scptoolbox_torch.utils import scene3d as ts3  # noqa: E402
from scptoolbox_torch.utils import trajectory as ttraj  # noqa: E402
from scptoolbox_torch.utils import tree as ttree  # noqa: E402
from scptoolbox_tpu import models as jmodels  # noqa: E402
from scptoolbox_tpu import utils as jutils  # noqa: E402
from scptoolbox_tpu.config import SCPStatus as JStatus  # noqa: E402
from scptoolbox_tpu.solvers import solution as jsolution  # noqa: E402
from scptoolbox_tpu.solvers import subproblem as jsub  # noqa: E402
from scptoolbox_tpu.utils import checkpoint as jckpt  # noqa: E402
from scptoolbox_tpu.utils import example_plots as jep  # noqa: E402
from scptoolbox_tpu.utils import geometry as jgeo  # noqa: E402
from scptoolbox_tpu.utils import integrate as jint  # noqa: E402
from scptoolbox_tpu.utils import interp as jinterp  # noqa: E402
from scptoolbox_tpu.utils import linsys as jlin  # noqa: E402
from scptoolbox_tpu.utils import plots as jplots  # noqa: E402
from scptoolbox_tpu.utils import scene3d as js3  # noqa: E402
from scptoolbox_tpu.utils import trajectory as jtraj  # noqa: E402
from scptoolbox_tpu.utils import tree as jtree  # noqa: E402
from tests import torch_refs as refs  # noqa: E402

torch.set_num_threads(1)
T64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
close = lambda a, b: np.testing.assert_allclose(
    np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-12)


def _grid(rng, N=9):
    t = np.sort(rng.uniform(0.0, 2.0, N))
    t[0], t[-1] = 0.0, 2.0
    return t, rng.standard_normal((N, 3))


def test_interp_and_trajectory_match_jax():
    rng = np.random.default_rng(0)
    t, f = _grid(rng)
    times = np.concatenate([rng.uniform(-0.5, 2.5, 12), t[[0, 3, 8]]])
    for tt in times:
        close(tinterp.get_interval(tt, T64(t)),
              jinterp.get_interval(tt, jnp.asarray(t)))
        for name in ("linterp", "zohinterp", "diracinterp"):
            close(getattr(tinterp, name)(tt, T64(f), T64(t)),
                  getattr(jinterp, name)(tt, jnp.asarray(f), jnp.asarray(t)))
        for kind in ("linear", "zoh", "impulse"):
            close(ttraj.sample(ttraj.ContinuousTimeTrajectory(
                T64(t), T64(f), kind), tt),
                jtraj.sample(jtraj.ContinuousTimeTrajectory(
                    jnp.asarray(t), jnp.asarray(f), kind), tt))
    # a batch of times at once, and a tensor time
    close(tinterp.get_interval(T64(times), T64(t)),
          jinterp.get_interval(jnp.asarray(times), jnp.asarray(t)))
    close(tinterp.linterp(T64(0.7), T64(f), T64(t)),
          jinterp.linterp(0.7, jnp.asarray(f), jnp.asarray(t)))
    close(tinterp.straightline_interpolate([1.0, -2.0], [3.0, 0.5], 7),
          jinterp.straightline_interpolate([1.0, -2.0], [3.0, 0.5], 7))
    close(tinterp.straightline_interpolate(2, 5, 4),
          jinterp.straightline_interpolate(2, 5, 4))
    with pytest.raises(ValueError, match="unknown interpolation"):
        ttraj.sample(ttraj.ContinuousTimeTrajectory(T64(t), T64(f), "x"),
                     0.1)


def test_rk4_grad_trapz_expm_diff_match_jax():
    rng = np.random.default_rng(1)
    M = rng.standard_normal((3, 3))
    t = np.sort(rng.uniform(0.0, 1.0, 7))
    x0 = rng.standard_normal(3)
    ft = lambda tt, x: (T64(M) @ x) * torch.cos(tt) + torch.sin(x)
    fj = lambda tt, x: (jnp.asarray(M) @ x) * jnp.cos(tt) + jnp.sin(x)
    at = lambda x: x / torch.linalg.vector_norm(x)
    aj = lambda x: x / jnp.linalg.norm(x)
    for actions in (None, "normalize"):
        for full in (False, True):
            close(tint.rk4(ft, T64(x0), T64(t), at if actions else None,
                           full),
                  jint.rk4(fj, jnp.asarray(x0), jnp.asarray(t),
                           aj if actions else None, full))
    close(tint.rk4_grid(ft, T64(x0), 0.2, 1.3, 5, full=True),
          jint.rk4_grid(fj, jnp.asarray(x0), 0.2, 1.3, 5, full=True))
    close(tint.grad_trapz(T64(t)), jint.grad_trapz(jnp.asarray(t)))
    A, dA = rng.standard_normal((2, 4, 4))
    close(tlin.expm_diff(T64(A), T64(dA), 0.7),
          jlin.expm_diff(jnp.asarray(A), jnp.asarray(dA), 0.7))


def test_subproblem_helpers_match_jax():
    rng = np.random.default_rng(2)
    lays = []
    for mod in (tsub, jsub):
        lay = mod.VarLayout()
        lay.add("a", 2, 3)
        lay.add("b")
        lay.add("c", 4)
        lays.append(lay)
    d = rng.standard_normal(11)
    for name in ("a", "b", "c"):
        close(lays[0].extract(T64(d), name),
              lays[1].extract(jnp.asarray(d), name))
    # batched d: the block after the leading dims
    assert lays[0].extract(T64(rng.standard_normal((5, 11))),
                           "a").shape == (5, 2, 3)

    dim, n, m = 4, 9, 9
    Q = rng.standard_normal((dim, dim))
    H = Q @ np.diag([2.0, 1.0, 0.5, -1e-3]) @ Q.T     # a clipped eigenvalue
    g, d0 = rng.standard_normal((2, dim))
    c0 = 0.3
    d_cols, t_col = np.array([1, 3, 4, 6]), 8
    rows = (2 + np.arange(dim + 2))[None, :]
    Jnp = rng.standard_normal((2, 3))
    v0 = rng.standard_normal(2)
    at = tsub.Assembler(m, n, 1, torch.float64, "cpu")
    aj = jsub.Assembler(m, n, jnp.float64)
    at.res_nonpos(np.array([0, 1]), np.array([0, 2, 5]), T64(Jnp), T64(v0))
    aj.res_nonpos(np.array([0, 1]), np.array([0, 2, 5]), jnp.asarray(Jnp),
                  jnp.asarray(v0))
    tsub.soc_epigraph_quadratic(at, rows, d_cols, t_col, T64(H), T64(g),
                                T64(c0), T64(d0))
    # JAX's Assembler takes the reservation's one row of SOC rows flat
    jsub.soc_epigraph_quadratic(aj, rows[0], d_cols, t_col, jnp.asarray(H),
                                jnp.asarray(g), c0, jnp.asarray(d0))
    At, Aj = at.A[0].numpy(), np.asarray(aj.A)
    # eigenvectors are defined up to sign: the L' rows are compared
    # through their Gram matrix, every other entry as it is
    close(At[:4], Aj[:4])
    close(at.b[0].numpy(), np.asarray(aj.b))
    close(At[4:].T @ At[4:], Aj[4:].T @ Aj[4:])
    # a batch of epigraphs, one per scenario
    ab = tsub.Assembler(m, n, 2, torch.float64, "cpu")
    tsub.soc_epigraph_quadratic(ab, rows, d_cols, t_col,
                                T64(np.stack([H, 2 * H])),
                                T64(np.stack([g, g])), T64([c0, c0]),
                                T64(np.stack([d0, d0])))
    close(ab.b[0].numpy(), np.asarray(aj.b) - np.asarray(
        jnp.zeros(m).at[:2].set(-v0)))


def _tree(mod):
    root = mod.TreeNode("root")
    a = mod.TreeNode("a", root)
    b = mod.TreeNode("b", root)
    aa, ab = mod.TreeNode("aa", a), mod.TreeNode("ab", a)
    ba = mod.TreeNode("ba", b)
    order = []
    root.traverse(lambda d, depth: order.append((d, depth)))
    lca = [mod.find_common(x, y).data
           for x, y in ((aa, ab), (aa, ba), (aa, a), (ba, b))]
    ab.set_parent(b)
    lca.append(mod.find_common(ab, ba).data)
    with pytest.raises(ValueError):
        mod.find_common(aa, mod.TreeNode("stranger"))
    return (order, root.findall(lambda d: d.startswith("a")), lca,
            [n.data for n in aa.ancestors()],
            root.find_node("ba") is None, [c.data for c in b.children])


def test_tree_matches_jax():
    assert _tree(ttree) == _tree(jtree)


def _solution_pair(sol):
    """The same solution as the JAX package's SCPSolution."""
    hist = [jsolution.IterationRecord(**{
        k: getattr(r, k) for k in (
            "iteration", "x", "u", "p", "J_aug", "J_orig", "feas",
            "deviation", "improv_rel", "ipm_status", "ipm_iters",
            "defect_norm", "vd_norm", "vs_norm")}) for r in sol.history]
    return jsolution.SCPSolution(
        status=JStatus(int(sol.status)), algorithm=sol.algorithm,
        iterations=sol.iterations, xd=sol.xd, ud=sol.ud, p=sol.p,
        cost=sol.cost, t_grid=sol.t_grid, feas=sol.feas, history=hist,
        t_cont=sol.t_cont, x_cont=sol.x_cont)


def _same_solution(a, b):
    assert (int(a.status), a.algorithm, a.iterations, a.feas) == (
        int(b.status), b.algorithm, b.iterations, b.feas)
    assert a.cost == b.cost
    for k in ("xd", "ud", "p", "t_grid", "t_cont", "x_cont"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert len(a.history) == len(b.history)
    for ra, rb in zip(a.history, b.history):
        for k in ("iteration", "J_aug", "J_orig", "feas", "deviation",
                  "improv_rel", "ipm_status", "ipm_iters", "defect_norm",
                  "vd_norm", "vs_norm"):
            np.testing.assert_equal(getattr(ra, k), getattr(rb, k), k)
        for k in ("x", "u", "p"):
            np.testing.assert_array_equal(getattr(ra, k), getattr(rb, k))


def test_checkpoints_cross_load_and_resume(tmp_path):
    pars = tptr.PTRParameters(**refs.DI_PARS)
    pbm = refs.tdi.double_integrator(
        refs.tdi.DoubleIntegratorParameters(**refs.DI_MODEL))
    sol = tptr.PTR(pbm, pars, device="cpu").solve()
    assert sol.status == SCPStatus.SOLVED
    # port -> JAX
    tckpt.save_solution(tmp_path / "port", sol)
    _same_solution(jckpt.load_solution(tmp_path / "port"), sol)
    # JAX -> port, then a warm resume from the loaded file
    jckpt.save_solution(str(tmp_path / "jax.npz"), _solution_pair(sol))
    back = tckpt.load_solution(tmp_path / "jax.npz")
    _same_solution(back, sol)
    sol2 = tptr.PTR(pbm, pars, device="cpu").solve(warm=back)
    assert sol2.status == SCPStatus.SOLVED and sol2.iterations <= 2
    assert sol2.cost == pytest.approx(sol.cost, rel=1e-4)
    # tensors are written as arrays; states round-trip both ways
    tsol = tsolution.SCPSolution(**{
        **sol.__dict__, "xd": T64(sol.xd), "ud": T64(sol.ud),
        "p": T64(sol.p)})
    tckpt.save_solution(tmp_path / "tensors", tsol)
    _same_solution(tckpt.load_solution(tmp_path / "tensors"), sol)
    state = {"x": T64(np.arange(6.0).reshape(2, 3)), "eta": 0.25,
             "rung": 3, "algo": "ptr", "done": False, "none": None}
    tckpt.save_state(tmp_path / "st", state)
    for back in (jckpt.load_state(tmp_path / "st"),
                 tckpt.load_state(tmp_path / "st")):
        np.testing.assert_array_equal(back["x"], state["x"].numpy())
        assert {k: back[k] for k in ("eta", "rung", "algo", "done",
                                     "none")} == {
            "eta": 0.25, "rung": 3, "algo": "ptr", "done": False,
            "none": None}


def _scenes(s3):
    """Numeric outputs of the scene pipeline, in either package."""
    out = {}
    cam = s3.Camera3D(fovy=90.0, aspect=1.3, znear=1.0, zfar=10.0)
    out["persp"] = s3.perspective(cam)
    out["frustum"] = s3.frustum(-1.0, 2.0, -0.5, 1.5, 0.5, 20.0)
    scene = s3.Scene3D()
    body = scene.add(s3.Axis3D(name="body", visible=True, axis_length=1.5))
    body.set_pose(s3.homtransf(s3.rot_z(0.5 * math.pi), [1.0, 0.0, 1.0]))
    tip = scene.add(s3.Axis3D(name="tip"), parent=body)
    tip.set_pose(s3.homtransf(s3.rot_x(0.3), [2.0, 0.0, 0.0]))
    c = scene.add(s3.Camera3D(name="cam", fovy=50.0, znear=0.2,
                              zfar=100.0))
    c.look_at([6.0, 6.0, 4.0], [0.0, 0.0, 0.0])
    out["rel"] = scene.relative_pose(tip, c)
    scene.add(s3.Light3D(az=300.0, el=60.0))
    scene.add(s3.sphere(0.8, az=12, el=6, face_color="lightsteelblue"),
              parent=body)
    scene.add(s3.box((1.0, 2.0, 0.5), center=(0.0, -1.0, 0.0),
                      face_color="gray"))
    traj = np.stack([np.linspace(-3, 3, 12), np.sin(np.linspace(0, 3, 12)),
                     np.linspace(0, 2, 12)], axis=1)
    scene.add(s3.polyline(traj, edge_color="orange", edge_width=1.5))
    scene.add(s3.line([0, 0, 20.0], [0, 1.0, 20.0]))   # behind the camera
    baked = scene.bake(c)
    out["tris"], out["fc"], out["ec"], out["ew"] = (
        baked.tris, baked.fc, baked.ec, baked.ew)
    return out


def test_scene3d_numbers_match_jax():
    got, want = _scenes(ts3), _scenes(js3)
    for k in ("persp", "frustum", "rel", "tris", "ew"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["fc"] == want["fc"] and got["ec"] == want["ec"]
    # tensors are taken as vertices
    m = ts3.Mesh3D(T64(np.eye(3)), [[0, 1, 2]])
    np.testing.assert_array_equal(m.V, np.eye(3))


def _fake(sol_mod, status, nx, nu, N=12, seed=1):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, N)
    xd = np.cumsum(rng.normal(size=(N, nx)) * 0.2, axis=0)
    return sol_mod.SCPSolution(
        status=status, algorithm="ptr", iterations=4, xd=xd,
        ud=rng.normal(size=(N, nu)), p=np.asarray([1.0]), cost=1.0,
        t_grid=t, feas=True, history=[], t_cont=np.linspace(0, 1, 4 * N),
        x_cont=np.repeat(xd, 4, axis=0)[: 4 * N])


def _history(sol_mod, seed):
    rng = np.random.default_rng(seed)
    x_star = rng.normal(size=(4, 2))
    return [sol_mod.IterationRecord(
        iteration=i + 1, x=x_star + 0.5 ** i * rng.normal(size=(4, 2)),
        u=rng.normal(size=(4, 1)), p=np.asarray([1.0]), J_aug=1.0,
        J_orig=1.0, feas=True, deviation=0.5 ** i, improv_rel=0.1,
        ipm_status=0, ipm_iters=10, defect_norm=1e-6,
        timing={"total": 0.1 + 0.01 * i}) for i in range(5)]


def _suites(ep, pl, sol_mod, status, geo, tensors):
    """Every figure of the plot suites, as the line data of its axes."""
    arr = T64 if tensors else jnp.asarray
    obs = [geo.Ellipsoid(arr(np.eye(3)), arr([1.0, 1.0, 0.0]))]
    rooms = [geo.Hyperrectangle.from_ranges((-1, 1), (-1, 1), (-1, 1))]
    f = lambda nx, nu: _fake(sol_mod, status, nx, nu)
    figs = [ep.plot_double_integrator(f(2, 1)),
            ep.plot_rocket_landing(f(7, 3)), ep.plot_oscillator(f(2, 1)),
            *ep.plot_quadrotor(f(6, 4), obs),
            *ep.plot_freeflyer(f(13, 6), rooms, obs),
            *ep.plot_starship(f(8, 3)),
            *ep.plot_rendezvous(f(6, 12), name="rdv"),
            pl.plot_convergence([_history(sol_mod, s) for s in range(3)]),
            pl.plot_trajectory_2d(f(2, 1), obstacles=[geo.Ellipsoid(
                arr(np.eye(2) * 4.0), arr([0.2, 0.2]))], prisms=[
                geo.Hyperrectangle.from_ranges((-1.5, 1.5), (-1.5, 1.5))])]
    data = [[[np.asarray(line.get_xydata()) for line in ax.get_lines()]
             for ax in fig.axes] for fig in figs]
    for fig in figs:
        plt.close(fig)
    return data


def test_plot_suites_draw_the_jax_lines():
    got = _suites(tep, tplots, tsolution, SCPStatus.SOLVED, tgeo, True)
    want = _suites(jep, jplots, jsolution, JStatus.SOLVED, jgeo, False)
    assert len(got) == len(want) == 14
    for g, w in zip(got, want):
        assert [len(a) for a in g] == [len(a) for a in w]
        for ga, wa in zip(g, w):
            for gl, wl in zip(ga, wa):
                np.testing.assert_allclose(gl, wl, rtol=1e-12, atol=1e-12)


def test_exports_match_jax():
    assert scptoolbox_torch.__all__ == scptoolbox_tpu.__all__
    assert scptoolbox_torch.__version__ == scptoolbox_tpu.__version__
    assert tutils.__all__ == jutils.__all__
    assert tmodels.__all__ == jmodels.__all__
    from scptoolbox_torch import parallel as tpar
    from scptoolbox_tpu import parallel as jpar
    assert tpar.__all__ == jpar.__all__
    for pkg, names in ((scptoolbox_torch, scptoolbox_torch.__all__),
                       (tutils, tutils.__all__), (tmodels, tmodels.__all__),
                       (tpar, tpar.__all__)):
        assert all(hasattr(pkg, n) for n in names)


def test_import_needs_no_matplotlib_and_builds_no_native_library():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['matplotlib'] = None\n"        # importing it fails
        "import scptoolbox_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from scptoolbox_torch import native\n"
        "assert native._lib is None and native._build_error is None\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
