"""Command-line entry point (the analog of `mpirun roms < roms_app.in`);
counterpart of ``python -m roms_tpu``:

    python -m roms_tpu_torch run config.yaml
    python -m roms_tpu_torch run --case upwelling --nsteps 100 --his his.nc
    python -m roms_tpu_torch run file_driven.yaml --device cpu
    python -m roms_tpu_torch cases

The run goes on the CUDA card unless `--device` names another; without a
card it fails with torch's error (no fallback to the CPU).  A 2-D-only
case (soliton) exits 2: it runs through ops.step2d.step_2d_only, which has
no run driver here or in roms_tpu.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="roms_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run a model case")
    runp.add_argument("yaml", nargs="?", help="YAML run configuration")
    runp.add_argument("--case", default=None)
    runp.add_argument("--nsteps", type=int, default=None)
    runp.add_argument("--his", default=None, help="history NetCDF path")
    runp.add_argument("--nhis", type=int, default=10)
    runp.add_argument("--rst", default=None,
                      help="restart path (one <rst>_<step>.pt a restart)")
    runp.add_argument("--nrst", type=int, default=0)
    runp.add_argument("--ninfo", type=int, default=10)
    runp.add_argument("--device", default="cuda",
                      help="torch device of the run (default cuda)")

    sub.add_parser("cases", help="list available model cases")

    args = ap.parse_args(argv)

    from .utils.yamlcfg import CASES, build_from_yaml, build_from_dict

    if args.cmd == "cases":
        for name in sorted(CASES):
            print(name)
        print("file")       # a YAML run with grid_file, ini_file, frc_file
        return 0

    if args.yaml:
        cfg, grid, state0, ffn, opts = build_from_yaml(args.yaml,
                                                       device=args.device)
    else:
        doc = {"case": args.case or "upwelling",
               "nsteps": args.nsteps or 10}
        cfg, grid, state0, ffn, opts = build_from_dict(doc,
                                                       device=args.device)
    if args.nsteps is not None:
        opts["nsteps"] = args.nsteps
    if args.his:
        opts.setdefault("his_file", args.his)
        opts.setdefault("nhis", args.nhis)
    if args.rst:
        opts.setdefault("rst_file", args.rst)
        opts.setdefault("nrst", args.nrst)
    # roms_tpu's CLI parses --ninfo but never reads it; here it takes
    # effect unless the YAML's output section sets ninfo
    opts.setdefault("ninfo", args.ninfo)

    if opts.get("mode") == "2d":
        # no 2-D run driver, as in roms_tpu
        print("2D-only case: use roms_tpu_torch.ops.step2d.step_2d_only "
              "directly", file=sys.stderr)
        return 2

    from .driver import Simulation

    print(f" roms_tpu_torch: case={cfg.name} "
          f"grid={cfg.Lm}x{cfg.Mm}x{cfg.N} dt={cfg.dt} "
          f"ndtfast={cfg.ndtfast} nfast={cfg.nfast}")
    print(f"    STEP   TIME(d)  diagnostics")
    sim = Simulation(cfg, grid, state0, ffn,
                     his_file=opts.get("his_file"),
                     nhis=int(opts.get("nhis", 0) or 0),
                     rst_file=opts.get("rst_file"),
                     nrst=int(opts.get("nrst", 0) or 0),
                     avg_file=opts.get("avg_file"),
                     navg=int(opts.get("navg", 0) or 0),
                     dia_file=opts.get("dia_file"),
                     ndia=int(opts.get("ndia", 0) or 0),
                     qck_file=opts.get("qck_file"),
                     nqck=int(opts.get("nqck", 0) or 0),
                     ndef_his=int(opts.get("ndef_his", 0) or 0),
                     ninfo=int(opts.get("ninfo", 10) or 0))
    sim.run(int(opts["nsteps"]))
    sim.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
