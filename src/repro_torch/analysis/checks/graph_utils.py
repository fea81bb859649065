"""``torch.fx`` graph helpers for the kernel aliasing lint (the port's
counterpart of ``repro.analysis.checks.jaxpr_utils``).

Nothing here runs device code: every analysis reads an aten graph that
``torch.fx.experimental.proxy_tensor.make_fx`` traced with fake tensors.
The graph is flat (Python loops unroll), in-place index writes stay in
it as ``index_put_``, and a Python number an op takes comes through as
a constant in the node's arguments, or one hop away as the argument of
an ``aten.scalar_tensor`` / ``aten.full`` node that materialised it.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Set, Tuple

import torch
from torch.fx.experimental.proxy_tensor import make_fx

#: ops that write through computed indices into an existing tensor
SCATTER_OPS = frozenset({
    "index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
    "index_copy", "index_copy_", "index_add", "index_add_",
})

#: comparisons that can express a bounds guard
CMP_OPS = frozenset({"lt", "le", "gt", "ge"})

#: selects (``torch.where``)
SELECT_OPS = frozenset({"where"})

#: ops that turn a Python number into a tensor
_LITERAL_OPS = frozenset({"scalar_tensor", "full", "full_like",
                          "lift_fresh_copy"})


def trace(fn: Callable, *args) -> torch.fx.GraphModule:
    """``fn(*args)`` traced to an aten graph on fake tensors (tensors
    ``fn`` closes over, such as weights, become the graph's constants)."""
    return make_fx(fn, tracing_mode="fake",
                   _allow_non_fake_inputs=True)(*args)


def op_name(node: torch.fx.Node) -> str:
    """The aten overload packet's name (``"index_put_"``), or ``""``
    for a placeholder, an attribute or the output."""
    if node.op != "call_function":
        return ""
    target = node.target
    packet = getattr(target, "overloadpacket", None)
    return getattr(packet, "__name__", getattr(target, "__name__", ""))


def _flat(args: Any) -> Iterable[Any]:
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from _flat(a)
        else:
            yield a


def input_nodes(node: torch.fx.Node) -> List[torch.fx.Node]:
    """The nodes ``node`` reads (through list arguments such as
    ``index_put_``'s indices)."""
    return [a for a in _flat(list(node.args) + list(node.kwargs.values()))
            if isinstance(a, torch.fx.Node)]


def literal_values(node: torch.fx.Node) -> List[Any]:
    """The Python numbers among ``node``'s arguments."""
    return [a for a in _flat(node.args)
            if isinstance(a, (int, float)) and not isinstance(a, bool)]


def mentions_literal(node: torch.fx.Node, value) -> bool:
    """``node`` takes ``value`` as a constant, directly or through an
    input that materialised it (one hop)."""
    if value in literal_values(node):
        return True
    return any(op_name(n) in _LITERAL_OPS and value in literal_values(n)
               for n in input_nodes(node))


def backward_slice(gm: torch.fx.GraphModule, seeds: Iterable[Any]
                   ) -> Tuple[List[torch.fx.Node], Set[torch.fx.Node]]:
    """``(nodes, sources)``: the graph's nodes the seeds depend on, in
    graph order, and the placeholders among them."""
    needed = {s for s in _flat(list(seeds)) if isinstance(s, torch.fx.Node)}
    stack = list(needed)
    while stack:
        for n in input_nodes(stack.pop()):
            if n not in needed:
                needed.add(n)
                stack.append(n)
    nodes = [n for n in gm.graph.nodes if n in needed]
    return nodes, {n for n in nodes if n.op == "placeholder"}


def placeholders(gm: torch.fx.GraphModule) -> List[torch.fx.Node]:
    return [n for n in gm.graph.nodes if n.op == "placeholder"]


def _shape(node: torch.fx.Node) -> Tuple[int, ...]:
    val = node.meta.get("val")
    return tuple(val.shape) if isinstance(val, torch.Tensor) else ()


def find_scatters(gm: torch.fx.GraphModule,
                  page_axis_size: int) -> List[torch.fx.Node]:
    """Scatter-family nodes whose written tensor has a dimension of
    ``page_axis_size`` (the pool's page axis, scratch included)."""
    return [n for n in gm.graph.nodes
            if op_name(n) in SCATTER_OPS and n.args
            and isinstance(n.args[0], torch.fx.Node)
            and page_axis_size in _shape(n.args[0])]


def scatter_index_args(node: torch.fx.Node) -> List[Any]:
    """The index operands of a scatter-family node (``index_put_``'s
    index list, ``scatter_``'s and ``index_copy_``'s index)."""
    name = op_name(node)
    if name in ("index_put", "index_put_", "_index_put_impl_"):
        return [a for a in node.args[1] if a is not None]
    return [node.args[2]] if len(node.args) > 2 else []
