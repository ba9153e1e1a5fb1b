"""Command-line surface of the port, mirroring setk_tpu.cli.

Every command is a module with ``make_parser()`` + ``run(args)``, run as
``python -m setk_tpu_torch.cli <command> ...``.  Flag names follow
setk_tpu's (and so the reference toolkit's) commands, so recipes
translate by changing the package name.
"""
