"""pytest plugin (-p jaxstub): stand-in modules for jax and the JAX package,
so that test files which import them at module level can be collected on a
machine without JAX. Only tests that never touch them may be selected."""
import importlib.abc
import importlib.machinery
import sys
import types
from unittest import mock


def _stubbed(name):
    return name == "jax" or name.startswith("jax.") or name == "opencl_fft_tpu" \
        or name.startswith("opencl_fft_tpu.")


class _Stub(types.ModuleType):
    def __getattr__(self, item):
        if item.startswith("__"):
            raise AttributeError(item)
        return mock.MagicMock(name=f"{self.__name__}.{item}")


class _Finder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        if _stubbed(name):
            return importlib.machinery.ModuleSpec(name, self, is_package=True)
        return None

    def create_module(self, spec):
        m = _Stub(spec.name)
        m.__path__ = []
        return m

    def exec_module(self, module):
        pass


sys.meta_path.insert(0, _Finder())
