"""A configuration's family, found by name: the program's dense model
(``families/<family>.py``), the plain reference (``reference/<family>.py``) and
the yardstick's counts (``yardstick/<family>.py``)."""

import importlib


def load(name: str):
    return importlib.import_module(f"families.{name}")


def reference(name: str):
    return importlib.import_module(f"reference.{name}")


def yardstick(name: str):
    return importlib.import_module(f"yardstick.{name}")
