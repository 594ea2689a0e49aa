"""Patch application: the three patch types of the reference API
(``endpoints/handlers/rest.go`` PATCH → strategic-merge / merge /
JSON-patch).  Shared by the server-side PATCH verb and kubectl patch."""

from __future__ import annotations

MERGE = "merge"
STRATEGIC = "strategic"
JSON_PATCH = "json"

CONTENT_TYPES = {
    "application/merge-patch+json": MERGE,
    "application/strategic-merge-patch+json": STRATEGIC,
    "application/json-patch+json": JSON_PATCH,
}


def merge_patch(base, overlay, strategic: bool = False):
    """RFC 7386 recursive merge (null deletes); with ``strategic``, lists
    whose members all carry a "name" key merge by name (the reference's
    patchMergeKey for containers/ports/env/volumes) instead of replacing
    wholesale."""
    if (strategic and isinstance(base, list) and isinstance(overlay, list)
            and all(isinstance(x, dict) and "name" in x for x in base + overlay)):
        out_list = list(base)
        index = {x["name"]: i for i, x in enumerate(out_list)}
        for item in overlay:
            i = index.get(item["name"])
            if i is None:
                out_list.append(item)
            else:
                out_list[i] = merge_patch(out_list[i], item, strategic)
        return out_list
    if not isinstance(base, dict) or not isinstance(overlay, dict):
        return overlay
    out = dict(base)
    for k, v in overlay.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = merge_patch(out.get(k), v, strategic)
    return out


def json_patch(base, ops):
    """RFC 6902 add/replace/remove with simple paths (the subset the
    reference's callers actually use)."""
    for op in ops:
        path = [p for p in op.get("path", "").split("/") if p]
        target = base
        for seg in path[:-1]:
            target = target[int(seg)] if isinstance(target, list) else target[seg]
        leaf = path[-1] if path else ""
        action = op.get("op")
        if isinstance(target, list):
            idx = len(target) if leaf == "-" else int(leaf)
            if action == "add":
                target.insert(idx, op.get("value"))
            elif action == "replace":
                target[idx] = op.get("value")
            elif action == "remove":
                del target[idx]
            else:
                raise ValueError(f"unsupported op {action!r}")
        else:
            if action in ("add", "replace"):
                target[leaf] = op.get("value")
            elif action == "remove":
                del target[leaf]
            else:
                raise ValueError(f"unsupported op {action!r}")
    return base


def apply_patch(current: dict, patch, patch_type: str) -> dict:
    if patch_type == JSON_PATCH:
        return json_patch(current, patch)
    return merge_patch(current, patch, strategic=patch_type == STRATEGIC)
