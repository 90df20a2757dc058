"""Generic class registry with name/alias lookup and JSON-config creation.

Capability parity with the reference's ``python/mxnet/registry.py``
(``get_register_func``, ``get_alias_func``, ``get_create_func``) — the
mechanism behind ``mx.metric.create('acc')``, ``mx.optimizer.create('adam')``,
``mx.init.Initializer`` registries, etc.
"""
from __future__ import annotations

import json
import warnings

from .base import MXNetError

_REGISTRY = {}


def _registry_for(base_class):
    return _REGISTRY.setdefault(base_class, {})


def get_register_func(base_class, nickname):
    """Make a ``register`` decorator for subclasses of ``base_class``."""
    registry = _registry_for(base_class)

    def register(klass, name=None):
        assert issubclass(klass, base_class), \
            "Can only register subclass of %s" % base_class.__name__
        if name is None:
            name = klass.__name__
        name = name.lower()
        if name in registry:
            warnings.warn(
                "New %s %s.%s registered with name %s is overriding "
                "existing %s %s.%s" % (
                    nickname, klass.__module__, klass.__name__, name,
                    nickname, registry[name].__module__,
                    registry[name].__name__))
        registry[name] = klass
        return klass

    register.__doc__ = "Register %s to the %s factory" % (
        nickname, nickname)
    return register


def get_alias_func(base_class, nickname):
    """Make an ``alias`` decorator registering extra names."""
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register(klass, name)
            return klass
        return reg
    return alias


def get_create_func(base_class, nickname):
    """Make a ``create(name_or_instance_or_json, *args, **kwargs)`` factory."""
    registry = _registry_for(base_class)

    def create(*args, **kwargs):
        if len(args):
            name = args[0]
            args = args[1:]
        else:
            name = kwargs.pop(nickname)
        if isinstance(name, base_class):
            assert len(args) == 0 and len(kwargs) == 0, \
                "%s is already an instance. Additional arguments are " \
                "invalid" % nickname
            return name
        if isinstance(name, dict):
            return create(**name)
        assert isinstance(name, str), "%s must be of string type" % nickname
        if name.startswith('['):
            assert not args and not kwargs
            name, kwargs = json.loads(name)
            return create(name, **kwargs)
        if name.startswith('{'):
            assert not args and not kwargs
            kwargs = json.loads(name)
            return create(**kwargs)
        name = name.lower()
        if name not in registry:
            raise MXNetError(
                "%s is not registered. Please register with %s.register "
                "first" % (name, nickname))
        return registry[name](*args, **kwargs)

    create.__doc__ = "Create a %s instance from config" % nickname
    return create
