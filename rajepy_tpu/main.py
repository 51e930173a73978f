#!/usr/bin/env python3
"""Command-line entry point (reference: main.py:14-87, same flags).

Usage:
    python -m rajepy_tpu.main [-v] [-rt] [-so] [-r] [-c] \
        model_param_file pipeline_param_file
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="rajepy_tpu",
        description="Radiative transfer and synthetic radio "
                    "observations of ionised YSO jets")
    parser.add_argument("model_param_file",
                        help="Full path to model parameter file", type=str)
    parser.add_argument("pipeline_param_file",
                        help="Full path to pipeline parameter file",
                        type=str)
    parser.add_argument("-v", "--verbose",
                        help="Increase output verbosity",
                        action="store_true")
    parser.add_argument("-rt", "--radiative-transfer",
                        help="Compute radiative transfer solutions",
                        action="store_true")
    parser.add_argument("-so", "--simobserve",
                        help="Conduct synthetic observations (on-device, "
                             "CASA-free)", action="store_true")
    parser.add_argument("-r", "--resume",
                        help="Resume previous pipeline run if present",
                        action="store_true")
    parser.add_argument("-c", "--clobber",
                        help="Overwrite any data products/files present",
                        action="store_true")
    return parser


def main(argv=None):
    from rajepy_tpu import JetModel, Pipeline, cfg, logger

    if argv is None and len(sys.argv) == 1:
        # No arguments: run the bundled example parameter files as a
        # dry-run smoke test (the reference's no-args path, main.py:69-77)
        jet_param_file = os.path.join(cfg.dcys['files'],
                                      'example-model-params.py')
        pline_param_file = os.path.join(cfg.dcys['files'],
                                        'example-pipeline-params.py')
        pline = Pipeline(JetModel(jet_param_file), pline_param_file)
        pline.execute(resume=False, clobber=False, simobserve=False,
                      dryrun=True)
        return pline

    args = build_parser().parse_args(argv)
    jet_param_file = os.path.abspath(args.model_param_file)
    pline_param_file = os.path.abspath(args.pipeline_param_file)

    pline_params = Pipeline.py_to_dict(pline_param_file)

    # Shared log for JetModel and Pipeline (main.py:49-58)
    log_name = ("ModelRun_" +
                time.strftime("%Y-%m-%d-%H:%M:%S", time.localtime()) +
                ".log")
    model_dcy = os.path.expanduser(pline_params['dcys']['model_dcy'])
    os.makedirs(model_dcy, exist_ok=True)
    log = logger.Log(fname=os.path.join(model_dcy, log_name),
                     verbose=args.verbose)

    pline = Pipeline(JetModel(jet_param_file, log=log), pline_params,
                     log=log)
    pline.log.add_entry(
        "INFO", "Pipeline initiated using model parameters defined in "
                f"{jet_param_file}, and pipeline parameters defined in "
                f"{pline_param_file}")
    pline.execute(resume=args.resume, clobber=args.clobber,
                  simobserve=args.simobserve, verbose=args.verbose,
                  dryrun=not args.radiative_transfer)

    # Copy the parameter files into the output directory (main.py:79-87)
    for f in (jet_param_file, pline_param_file):
        dest = os.path.join(model_dcy, os.path.basename(f))
        if os.path.abspath(f) != os.path.abspath(dest):
            try:
                shutil.copyfile(f, dest)
            except shutil.SameFileError:
                pass
    return pline


if __name__ == '__main__':
    main()
