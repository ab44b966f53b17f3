"""Generic n-ary tree (reference src/utils/tree.jl:77-269): the pose
hierarchy substrate for the 3D scene graph (utils/scene3d.py).

The port's own copy of `scptoolbox_tpu/utils/tree.py` (plain Python).

Unlike the reference's trait-based compatibility machinery
(IsTreeCompatible/owner, tree.jl:35-72), nodes here simply carry an opaque
`data` payload and the scene objects keep a back-reference — idiomatic
Python, same capabilities: add/remove/reparent, depth-first traversal,
predicate search, and lowest-common-ancestor (`find_common`)."""

from __future__ import annotations

from typing import Any, Callable, List, Optional


class TreeNode:
    """One tree node holding `data` (reference TreeNode, tree.jl:77-114)."""

    def __init__(self, data: Any, parent: Optional["TreeNode"] = None):
        self.data = data
        self.parent: Optional[TreeNode] = None
        self.children: List[TreeNode] = []
        if parent is not None:
            parent.add_child(self)

    # -- structure editing (tree.jl:133-168) ------------------------------

    def add_child(self, *nodes: "TreeNode") -> None:
        for node in nodes:
            assert node.parent is None, "node already has a parent"
            node.parent = self
            self.children.append(node)

    def remove_child(self, child: "TreeNode") -> None:
        self.children.remove(child)
        child.parent = None

    def set_parent(self, parent: "TreeNode") -> None:
        if self.parent is not None:
            self.parent.remove_child(self)
        parent.add_child(self)

    @property
    def is_root(self) -> bool:
        return self.parent is None

    # -- traversal & search (tree.jl:182-269) ------------------------------

    def traverse(self, action: Callable[[Any, int], Any],
                 depth: int = 0) -> None:
        """Depth-first pre-order traversal; `action(data, depth)`."""
        action(self.data, depth)
        for child in self.children:
            child.traverse(action, depth + 1)

    def findall(self, matcher: Callable[[Any], bool]) -> List[Any]:
        """All data payloads in the subtree for which `matcher(data)`."""
        out: List[Any] = []
        self.traverse(lambda data, _: out.append(data)
                      if matcher(data) else None)
        return out

    def find_node(self, data: Any) -> Optional["TreeNode"]:
        """The node holding `data` (identity comparison), or None."""
        if self.data is data:
            return self
        for child in self.children:
            hit = child.find_node(data)
            if hit is not None:
                return hit
        return None

    def ancestors(self) -> List["TreeNode"]:
        """Path from this node up to (and including) the root."""
        path = [self]
        node = self
        while node.parent is not None:
            node = node.parent
            path.append(node)
        return path


def find_common(a: TreeNode, b: TreeNode) -> TreeNode:
    """Lowest common ancestor of two nodes (reference find_common,
    tree.jl:254-269). Raises ValueError when the nodes share no tree."""
    seen = set(id(n) for n in a.ancestors())
    for node in b.ancestors():
        if id(node) in seen:
            return node
    raise ValueError("nodes do not share a common ancestor")
