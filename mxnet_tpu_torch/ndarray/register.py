"""Generate the ``mx.nd.*`` op functions from the port's registry.

The port's counterpart of the JAX package's ``ndarray/register.py``
(reference: ``python/mxnet/ndarray/register.py``): one closure per op.
Positional NDArray arguments and tensor keywords go to the op's input
fields; everything else becomes an attr.
"""
from __future__ import annotations

from ..ops import registry as _reg


def make_op_func(op_name):
    reg = _reg.get(op_name)

    def generic(*args, **kwargs):
        from .ndarray import NDArray

        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        if reg.variadic:
            inputs = [a for a in args if isinstance(a, NDArray)]
            attrs = kwargs
            fields = None
        else:
            n_in = len(reg.input_names)
            named = list(zip(reg.input_names, args[:n_in]))
            inputs = [a for _, a in named if a is not None]
            fields = [f for f, a in named if a is not None]
            for nm in reg.input_names[len(inputs):]:
                if nm in kwargs and isinstance(kwargs[nm], NDArray):
                    inputs.append(kwargs.pop(nm))
                    fields.append(nm)
            attrs = kwargs
            # excess positional args are attrs, in signature order
            # (e.g. transpose(x, (2, 0, 1)))
            extra = args[n_in:]
            if len(extra) > len(reg.attr_names):
                raise TypeError(
                    "%s takes at most %d positional arguments (%d given)"
                    % (op_name, n_in + len(reg.attr_names), len(args)))
            for nm, val in zip(reg.attr_names, extra):
                if nm in attrs:
                    raise TypeError("%s got multiple values for argument %r"
                                    % (op_name, nm))
                attrs[nm] = val
        return _reg.invoke(op_name, inputs, attrs, out=out,
                           fields=tuple(fields) if fields is not None
                           else None)

    generic.__name__ = op_name
    generic.__doc__ = reg.doc
    return generic


def populate(namespace_dict, exclude_internal=False):
    """Install every registered op into a module namespace (``mx.nd``)."""
    for name in _reg.list_ops():
        if name.startswith("_") and exclude_internal:
            continue
        namespace_dict.setdefault(name, make_op_func(name))
