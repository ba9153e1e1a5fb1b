"""Dispatcher: ``python -m setk_tpu_torch.cli <command> [args...]``.

The port's counterpart of ``setk_tpu/cli/__main__.py``.  Where a command
runs is its own ``--device`` flag (``cuda`` by default).
"""

import importlib
import pkgutil
import sys

import setk_tpu_torch.cli as cli_pkg

_EXCLUDE = {"common", "__main__"}


def available_commands():
    return sorted(
        name for _, name, _ in pkgutil.iter_modules(cli_pkg.__path__)
        if name not in _EXCLUDE)


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("Usage: python -m setk_tpu_torch.cli <command> [args...]\n")
        print("Commands:")
        for name in available_commands():
            print(f"  {name}")
        return 0
    command = sys.argv[1]
    if command not in available_commands():
        print(f"Unknown command: {command}", file=sys.stderr)
        return 1
    mod = importlib.import_module(f"setk_tpu_torch.cli.{command}")
    args = mod.make_parser().parse_args(sys.argv[2:])
    mod.run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
