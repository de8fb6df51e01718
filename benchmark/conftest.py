"""The entry ``train_unet`` in the tables of the benchmark's tests, which
know the entries ``serve``, ``chain`` and ``train`` by name: it trains
through ``train/loop.py::fit`` as ``train`` does, so it takes the training
faults (``faults.FAULTS``) and the training cell's CPU sizes
(``tests/conftest.py::SMALL``: 24x32, divisible by 8 as the uNet's three
strides need).  A ``benchmark`` change that adds the key to both
tables makes this file unneeded."""
import os

from benchmark import faults

ENTRY = "train_unet"

faults.FAULTS.setdefault(ENTRY, faults.FAULTS["train"])
if not hasattr(faults, "_" + ENTRY):
    setattr(faults, "_" + ENTRY, faults._train)


def pytest_collection_modifyitems(session, config, items):
    tests_conftest = os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests", "conftest.py")
    for plugin in config.pluginmanager.get_plugins():
        if getattr(plugin, "__file__", None) == tests_conftest:
            small = plugin.SMALL
            small.setdefault(ENTRY, small["train"])
