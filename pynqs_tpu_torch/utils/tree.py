"""Parameter trees in the JAX package's layout.

A JAX parameter tree is nested dicts (and lists, such as the decoder's
``"blocks"``) with array leaves; the port names each parameter by its
dotted path in that tree (``blocks.0.qkv.w`` ↔
``tree["blocks"][0]["qkv"]["w"]``).  A flat tree (``GraphMPSRNN``'s)
has the parameter names themselves as paths.
"""

from __future__ import annotations

from torch import nn

__all__ = ["flatten_tree", "unflatten_tree", "tree_named_parameters", "tree_order"]


def flatten_tree(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a nested dict/list tree, in JAX's leaf order
    (dict keys sorted, sequences in order)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten_tree(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}."))
        return out
    return {} if tree is None else {prefix[:-1]: tree}


def _lists(node):
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node) and sorted(map(int, node)) == list(
            range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def unflatten_tree(named: dict):
    """Inverse of ``flatten_tree``: nested dicts in the order the names
    come, a node whose keys are 0..n−1 a list.  A flat dict comes back
    as it is."""
    root: dict = {}
    for name, v in named.items():
        node = root
        *head, last = name.split(".")
        for seg in head:
            node = node.setdefault(seg, {})
        node[last] = v
    return _lists(root)


def _tree_path(model: nn.Module, name: str) -> str:
    out, m = [], model
    for seg in name.split("."):
        if getattr(m, "tree_transparent", None) != seg:
            out.append(seg)
        m = getattr(m, seg, None)
    return ".".join(out)


def tree_named_parameters(model: nn.Module) -> dict:
    """{dotted JAX-tree path: parameter} of any model (a flat model's are
    its parameter names)."""
    return {_tree_path(model, n): p for n, p in model.named_parameters()}


def tree_order(names) -> list:
    """``names`` (dotted paths) in JAX's leaf order: optax's order of the
    moments in an optimizer state."""
    return list(flatten_tree(unflatten_tree({n: n for n in names})).values())
