"""The frozen work formulas against counts made by hand, two shapes a
kernel."""

import pytest

from benchmark import roofline


@pytest.mark.parametrize("kernel,dt,nb,n,K,flops,nbytes", [
    # 2 x (2/3 27 + 9/2) flops; 2 x (2 x 9 x 4 + 4 x 3) bytes
    ("lu_factor", "f32", 2, 3, 0, 45.0, 168),
    # 512 x (2/3 158^3 + 158^2 / 2); 512 x (2 x 158^2 x 4 + 4 x 158)
    ("lu_factor", "f32", 512, 158, 0, 1352715946.6666667, 102576128),
    # 2 x 3^2 x 1 x 2 flops; 3^2 x 8 + 4 x 3 + 2 x 3 x 1 x 8 bytes
    ("lu_solve", "f64", 1, 3, 1, 18.0, 132),
    ("lu_solve", "f32", 512, 158, 2, 51126272.0, 52744192),
    # 4^3 / 3; (10 + 16) x 4
    ("cholesky", "f32", 1, 4, 0, 64.0 / 3.0, 104),
    ("cholesky", "f64", 1, 53, 0, 148877.0 / 3.0, 33920),
    # 3^2 x 2; (6 + 12) x 8
    ("solve_lower", "f64", 1, 3, 2, 18.0, 144),
    ("solve_lower_t", "f64", 1, 53, 2, 5618.0, 13144),
])
def test_work_by_hand(kernel, dt, nb, n, K, flops, nbytes):
    f, b = roofline.work(kernel, nb, n, K, roofline.ITEM_SIZE[dt])
    assert f == pytest.approx(flops, rel=1e-12)
    assert b == nbytes


@pytest.mark.parametrize("key,ms,by", [
    # the kernel table's bounds in PERF.md: 0.03062, 0.01574,
    # 1.013e-05 and 3.924e-06 ms, all bound by bytes
    (("lu_factor", "f32", 512, 158, 0), 0.03062, "bytes"),
    (("lu_solve", "f32", 512, 158, 2), 0.01574, "bytes"),
    (("cholesky", "f64", 1, 53, 0), 1.013e-05, "bytes"),
    (("solve_lower_t", "f64", 1, 53, 2), 3.924e-06, "bytes"),
    # 1 x 2000^3 / 3 flops over 67 TFLOP/s: 0.0398 ms, above its 0.0143
    (("cholesky", "f64", 1, 2000, 0), 0.039800995024875625, "operations"),
])
def test_bound(key, ms, by):
    t, got = roofline.bound_s(*key)
    assert t * 1e3 == pytest.approx(ms, rel=2e-3)
    assert got == by


def test_bound_total_takes_its_share_only():
    shapes = {("lu_factor", "f32", 512, 158, 0): 2,
              ("solve_lower", "f32", 1, 53, 2): 3,
              ("solve_lower_t", "f32", 1, 53, 2): 1}
    assert roofline.bound_total(shapes, "lu_factor") == pytest.approx(
        2 * roofline.bound_s("lu_factor", "f32", 512, 158, 0)[0])
    assert roofline.bound_total(shapes, "tri_solve") == pytest.approx(
        4 * roofline.bound_s("solve_lower", "f32", 1, 53, 2)[0])
    assert roofline.bound_total(shapes, "cholesky") == 0.0
