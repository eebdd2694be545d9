"""One rules engine for per-leaf annotations: the port's counterpart of
tpudl.rules.

A rule list of ``(path_regex, value)`` pairs is matched against each
leaf's path string with ``re.search``; the FIRST match wins; an
uncovered leaf raises, naming it, unless the caller opts into an
explicit default. The precision policy (tpudl_torch.train.precision)
resolves its cast and moment rules through here.

The port's leaves are state_dict names (``bert.encoder.layer_0
.attention.query.weight``), tpudl's are tree paths (``bert/encoder/
layer_0/attention/query/kernel``), and tpudl's rules are written against
the latter (``(kernel|embedding)$``). So ``annotate`` takes a ``path``
function, the model's inverse weight bridge (``tpudl_path`` in
tpudl_torch.models.bert and .llama), and matches each rule on the tpudl
path: the same regex selects the same leaf in both packages.
``match_partition_rules`` (placement) belongs to sharding and raises,
naming ROADMAP queue A item 7.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

#: One rule: (regex searched — not fullmatched — against the leaf's
#: path string, annotation value).
Rule = Tuple[str, Any]
Rules = Sequence[Rule]


class _NoMatch:
    """Sentinel: no rule covered the path (distinct from a rule that
    matched with value ``None``, which means "keep")."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - repr cosmetics
        return "tpudl_torch.rules.NO_MATCH"


NO_MATCH = _NoMatch()


def path_str(name: str) -> str:
    """'a/b/weight' from the '.'-joined name 'a.b.weight' (tpudl's
    ``path_str`` of a jax key path; a model's ``tpudl_path`` also renames
    the leaf as tpudl's tree does)."""
    return name.replace(".", "/")


def first_match(rules: Optional[Rules], path: str) -> Any:
    """Value of the first rule whose regex searches into ``path``, else
    ``NO_MATCH``."""
    if rules:
        for pattern, value in rules:
            if re.search(pattern, path):
                return value
    return NO_MATCH


def annotate(
    rules: Optional[Rules],
    leaves: Dict[str, Any],
    *,
    path: Callable[[str], str] = path_str,
    default: Any = NO_MATCH,
    what: str = "rule",
) -> Dict[str, Any]:
    """name -> annotation for every leaf of ``leaves`` (a dict keyed by
    name, e.g. ``model.named_parameters()``), the first rule matching
    ``path(name)`` winning. An uncovered leaf raises ``ValueError``
    naming it, unless an explicit ``default`` is given; ``what`` names
    the rule family in the message."""
    out = {}
    for name in leaves:
        p = path(name)
        value = first_match(rules, p)
        if value is NO_MATCH:
            if default is NO_MATCH:
                raise ValueError(
                    f"no {what} matches parameter {p!r} — add an "
                    f"explicit (pattern, None) keep rule or a catch-all")
            value = default
        out[name] = value
    return out


def match_partition_rules(rules, tree, *, default=NO_MATCH):
    raise NotImplementedError(
        "match_partition_rules (placement) is not ported to tpudl_torch yet "
        "(ROADMAP queue A item 7 (launcher and sharding))")
