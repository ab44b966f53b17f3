#!/usr/bin/env python3
"""Summaries of a chip_smoke.py record for PERF.md.

    python3 scripts/torch_perf_summary.py RECORD

RECORD is the JSON record a full chip_smoke.py run writes.

Prints, from the record's kernels phase and path phases alone (nothing is
measured here): each path's wall beside its kernel time and the library
time of the same launches (each group's launches x its wrapper time, or x
the torch.linalg call's time, both timed at the group's largest batch); for
each kernel, launches x (time - bound) summed over every path; and one
kernel-table row per (kernel, dtype, n, K) group with its launches per path.
"""

import collections
import json
import sys

ABBR = {"starship": "SS", "starship_f64": "SS64",
        "starship_f64_block": "SS64b", "double_integrator_crpl": "DI crpl",
        "double_integrator_schur": "DI Schur", "oscillator": "osc",
        "lcvx_di_1": "LCvx 1", "lcvx_di_2": "LCvx 2", "lcvx_rocket": "rocket",
        "starship_setup": "SS set-up",
        "starship_serial_lu_setup": "serial set-up",
        "rendezvous_planar": "RP", "rendezvous_3d": "R3",
        "quadrotor_scvx": "Q", "freeflyer_scvx": "FF",
        "starship_scvx": "SSc", "quadrotor_scvx_batched": "Qb",
        "quadrotor_scvx_projection": "Q proj",
        "freeflyer_scvx_projection": "FF proj",
        "freeflyer_scvx_setup": "FF set-up",
        "starship_scvx_projection": "SSc proj",
        "quadrotor_gusto": "G", "quadrotor_gusto_softplus": "Gsp",
        "quadrotor_gusto_qrchol": "Gqr", "freeflyer_gusto_step": "FFg",
        "quadrotor_gusto_batched": "Gb",
        "quadrotor_gusto_projection": "G proj",
        "quadrotor_gusto_softplus_projection": "Gsp proj",
        "quadrotor_gusto_qrchol_projection": "Gqr proj",
        "freeflyer_gusto_step_setup": "FFg set-up",
        "starship_f64_staged_lu": "SSlu", "starship_f64_staged_qr": "SSqr",
        "double_integrator_staged_lu": "DI lu",
        "double_integrator_staged_qr": "DI qr",
        "starship_crqd_kkt": "CRQD ipm", "starship_crqd_kkt_crqd": "CRQD",
        "starship_crqd_kkt_crpl": "CRQD crpl",
        "quadrotor_gusto_softplus_staged_staged_cr": "Gsp cr",
        "quadrotor_gusto_softplus_staged_auto_f32": "Gsp f32",
        "quadrotor_gusto_softplus_staged_staged_cr_projection":
            "Gsp cr proj",
        "conic_parser": "parser",
        "kernels": "checks"}
ORDER = ("lu_factor", "lu_solve", "cholesky", "solve_lower", "solve_lower_t",
         "gj_inverse")


def _walls(rec):
    """{path: wall s} of every driven run."""
    out = {}
    for name, r in rec.items():
        if isinstance(r, dict) and "wall_s" in r:
            out[name] = r["wall_s"]
        elif isinstance(r, dict):
            for sub, x in r.items():
                if isinstance(x, dict) and "wall_s" in x:
                    out[f"{name}_{sub}"] = x["wall_s"]
    return out


def main(path):
    rec = json.load(open(path))
    rows = rec["kernels"]
    walls = _walls(rec)
    lib = collections.Counter()
    for r in rows:
        lib[r["path"]] += r["launches"] * r["library_ms"] / 1e3
    print("path | wall s | kernel s | library s")
    for p, kt in rec["kernel_time_s"].items():
        print(f"{p} | {walls.get(p, float('nan')):.4g} | {kt['total']:.4g} | "
              f"{lib[p]:.4g}")
    excess = collections.Counter()
    for r in rows:
        if r["path"] != "kernels":
            excess[r["kernel"]] += (r["launches"]
                                    * (r["kernel_ms"] - r["bound_ms"]) / 1e3)
    print("kernel | launches x (time - bound) s")
    for k, v in excess.most_common():
        print(f"{k} | {v:.3g}")
    groups = collections.defaultdict(list)
    for r in rows:
        groups[(r["kernel"], r["dtype"], r["n"], r["K"])].append(r)
    g = lambda x: f"{x:.4g}"
    for kernel in ORDER:
        print(f"-- {kernel}")
        for (k, dt, n, K), rs in groups.items():
            if k != kernel:
                continue
            r = max(rs, key=lambda x: x["launches"])
            nb, f64 = r["bound_nb"], " f64" if dt == "float64" else ""
            label = (f"{nb}x{n}²{f64}" if k in ("lu_factor", "cholesky",
                                                 "gj_inverse")
                     else f"{nb}x{n}, K={K}{f64}")
            launches = " + ".join(f"{x['launches']} "
                                  f"{ABBR.get(x['path'], x['path'])}"
                                  for x in rs)
            err = max(x["max_abs_err"] for x in rs)
            print(f"| {label} | {launches} | {g(r['kernel_ms'])} | "
                  f"{g(r['device_ms'])} | {g(r['bound_ms'])} "
                  f"({r['bound_by'][0]}) | {g(r['plain_ms'])} | "
                  f"{g(r['library_ms'])} | max abs err {err}")


if __name__ == "__main__":
    main(sys.argv[1])
