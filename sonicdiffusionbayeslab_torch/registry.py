"""The port's plugin registries: models, methods, metrics and schedulers.

Counterpart of ``sonicdiffusionbayeslab_tpu/registry.py``.  Registration
happens when the plugin modules are imported; :func:`load_all_plugins`
(the CLI calls it) imports them all.  Each registry also knows the names
the JAX package registers that the port does not have yet, so that looking
one up says it is not ported rather than unknown.
"""

from __future__ import annotations

from typing import Iterable

from sonicdiffusionbayeslab_torch.utils.class_registry import ClassRegistry, RegistryError


class PortRegistry(ClassRegistry):
    """A :class:`ClassRegistry` that names the JAX package's entries the
    port lacks in the error it raises for them."""

    def __init__(self, registry_name: str, not_ported: Iterable[str]) -> None:
        super().__init__(registry_name)
        self.not_ported = frozenset(not_ported)

    def __getitem__(self, name: str) -> type:
        if name in self.not_ported and name not in self._classes:
            ported = ", ".join(sorted(self._classes)) or "<none yet>"
            raise RegistryError(
                f"{self.registry_name}: {name!r} is not ported yet to the PyTorch package; "
                f"ported: {ported}")
        return super().__getitem__(name)


models_registry = PortRegistry("models_registry", ())
methods_registry = PortRegistry("methods_registry", ())
metrics_registry = PortRegistry("metrics_registry", ())
schedulers_registry = PortRegistry("schedulers_registry", ())


def load_all_plugins() -> None:
    """Import every module that registers plugins (imports are cached, so
    calling it again does nothing)."""
    import sonicdiffusionbayeslab_torch.experiments  # noqa: F401
    import sonicdiffusionbayeslab_torch.metrics  # noqa: F401
    import sonicdiffusionbayeslab_torch.models.pipelines  # noqa: F401
    import sonicdiffusionbayeslab_torch.schedulers  # noqa: F401
