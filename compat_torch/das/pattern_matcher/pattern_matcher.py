"""The `das` package's pattern matcher (reference
das/pattern_matcher/pattern_matcher.py:21-748) over das_tpu_torch.

The assignment algebra and the expression language come from
das_tpu_torch.query.  The composable classes (`Link`, `LinkTemplate`,
`Not`, `Or`, `And`) are subclasses whose `matched(db, answer)` goes
through the port's router first (query/compiler.py `dispatch`): the
reference's scripts call `expr.matched(das.db, answer)` on the expression
itself, never through `DistributedAtomSpace.query`, and without this the
card would never see their queries.  On a MemoryDB the router answers on
the host algebra at once.

`host_matched` is the plain host evaluator.  The router falls back to it
when the device path declines a query or overflows, so the fallback never
re-enters the routed `matched`.
"""

from das_tpu_torch.query import ast as _ast
from das_tpu_torch.query import compiler as _compiler
from das_tpu_torch.query.assignment import (  # noqa: F401
    CONFIG,
    Assignment,
    Compatibility as CompatibilityStatus,
    CompositeAssignment,
    OrderedAssignment,
    UnorderedAssignment,
)
from das_tpu_torch.query.ast import (  # noqa: F401
    Atom,
    LogicalExpression,
    Node,
    PatternMatchingAnswer,
    TypedVariable,
    Variable,
)


def _routed(cls):
    """A subclass of `cls` whose matched() tries the router first and whose
    host_matched() is `cls`'s own host evaluator."""

    def matched(self, db, answer):
        return _compiler.dispatch(db, self, answer, host=self.host_matched)

    def host_matched(self, db, answer):
        return cls.matched(self, db, answer)

    return type(cls.__name__, (cls,), {"matched": matched, "host_matched": host_matched})


Link = _routed(_ast.Link)
LinkTemplate = _routed(_ast.LinkTemplate)
Not = _routed(_ast.Not)
Or = _routed(_ast.Or)
And = _routed(_ast.And)
