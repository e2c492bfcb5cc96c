"""Decorator-based plugin registry with signature validation.

The port's own copy of ``sonicdiffusionbayeslab_tpu/utils/class_registry.py``
(stdlib only): ``@reg.add_to_registry(name)`` records each class with the
arg specs of its ``__init__``, ``validate_kwargs`` rejects unknown keys and
reports missing required ones before anything is instantiated, and
``build`` validates then instantiates.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Generic, Iterator, Mapping, TypeVar

T = TypeVar("T")

_MISSING = object()


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """One ``__init__`` (or factory) argument: its name, default, annotation."""

    name: str
    default: Any = _MISSING
    annotation: Any = _MISSING

    @property
    def required(self) -> bool:
        return self.default is _MISSING


def make_arg_specs(fn: Callable[..., Any]) -> Dict[str, ArgSpec]:
    """Extract an ordered {name: ArgSpec} map from a callable's signature.

    ``self``/``cls`` and ``*args``/``**kwargs`` catch-alls are dropped; a
    callable with a ``**kwargs`` catch-all is marked open (see OPEN_KEY) so
    validation only checks the explicitly declared names.
    """
    specs: Dict[str, ArgSpec] = {}
    sig = inspect.signature(fn)
    for name, p in sig.parameters.items():
        if name in ("self", "cls"):
            continue
        if p.kind is inspect.Parameter.VAR_POSITIONAL:
            continue
        if p.kind is inspect.Parameter.VAR_KEYWORD:
            specs[OPEN_KEY] = ArgSpec(OPEN_KEY)
            continue
        specs[name] = ArgSpec(
            name=name,
            default=_MISSING if p.default is inspect.Parameter.empty else p.default,
            annotation=_MISSING if p.annotation is inspect.Parameter.empty else p.annotation,
        )
    return specs


OPEN_KEY = "__var_keyword__"


class RegistryError(KeyError):
    pass


class ClassRegistry(Generic[T]):
    """Name → class registry. ``@reg.add_to_registry("name")`` to register.

    Lookup is ``reg["name"]``; each entry carries arg specs derived from the
    registered class's ``__init__`` for config validation.
    """

    def __init__(self, registry_name: str = "registry") -> None:
        self.registry_name = registry_name
        self._classes: Dict[str, type] = {}
        self._arg_specs: Dict[str, Dict[str, ArgSpec]] = {}

    def add_to_registry(self, name: str) -> Callable[[type], type]:
        def register(cls: type) -> type:
            if name in self._classes and self._classes[name] is not cls:
                raise RegistryError(
                    f"{self.registry_name}: duplicate registration of {name!r} "
                    f"({self._classes[name]!r} vs {cls!r})"
                )
            self._classes[name] = cls
            init = cls.__init__ if isinstance(cls, type) else cls
            self._arg_specs[name] = make_arg_specs(init)
            return cls

        return register

    def __getitem__(self, name: str) -> type:
        try:
            return self._classes[name]
        except KeyError:
            known = ", ".join(sorted(self._classes)) or "<empty>"
            raise RegistryError(
                f"{self.registry_name}: unknown name {name!r}; registered: {known}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._classes

    def __iter__(self) -> Iterator[str]:
        return iter(self._classes)

    def keys(self):
        return self._classes.keys()

    def arg_specs(self, name: str) -> Dict[str, ArgSpec]:
        self[name]  # raise nicely on unknown
        return self._arg_specs[name]

    def validate_kwargs(
        self,
        name: str,
        kwargs: Mapping[str, Any],
        *,
        allow_missing: bool = False,
    ) -> None:
        """Check ``kwargs`` against the registered class's signature.

        Raises ``TypeError`` on unknown keys (unless the signature has a
        ``**kwargs`` catch-all) and on missing required arguments (unless
        ``allow_missing``).
        """
        specs = self.arg_specs(name)
        open_sig = OPEN_KEY in specs
        unknown = [k for k in kwargs if k not in specs]
        if unknown and not open_sig:
            raise TypeError(
                f"{self.registry_name}[{name}]: unknown config keys {sorted(unknown)}; "
                f"accepted: {sorted(k for k in specs if k != OPEN_KEY)}"
            )
        if not allow_missing:
            missing = [
                s.name
                for s in specs.values()
                if s.required and s.name != OPEN_KEY and s.name not in kwargs
            ]
            if missing:
                raise TypeError(
                    f"{self.registry_name}[{name}]: missing required config keys {missing}"
                )

    def build(self, name: str, /, **kwargs: Any) -> T:
        """Validate then instantiate."""
        self.validate_kwargs(name, kwargs)
        return self[name](**kwargs)
