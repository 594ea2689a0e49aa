"""OpenAPI (swagger 2.0) document generation from the live type registry.

Capability of the reference's published schema
(``api/openapi-spec/swagger.json``; served by
``staging/src/k8s.io/apiserver/pkg/server/routes/openapi.go``): a
machine-readable description of every kind's wire shape and every
resource's REST surface, generated — not handwritten — from the same
registry the server decodes with, so CRD-registered kinds appear the
moment they establish.

Schemas are inferred by walking each kind's canonical wire form (the
``to_dict`` of a default instance): the era's codegen derived swagger
from Go struct tags; here the dataclass wire encoding IS the source of
truth, so inferring from it cannot drift from what the server actually
speaks.
"""

from __future__ import annotations

import logging
from typing import Optional

from .. import __version__
from ..api.types import CLUSTER_SCOPED_KINDS, KIND_PLURALS, KINDS

logger = logging.getLogger("kubernetes_tpu_torch.apiserver")

_SWAGGER_VERSION = "2.0"


def _schema_for(value) -> dict:
    if isinstance(value, bool):
        return {"type": "boolean"}
    if isinstance(value, int):
        return {"type": "integer", "format": "int64"}
    if isinstance(value, float):
        return {"type": "number", "format": "double"}
    if isinstance(value, str):
        return {"type": "string"}
    if isinstance(value, list):
        items = _schema_for(value[0]) if value else {"type": "object"}
        return {"type": "array", "items": items}
    if isinstance(value, dict):
        if not value:
            return {"type": "object", "additionalProperties": True}
        return {
            "type": "object",
            "properties": {str(k): _schema_for(v) for k, v in value.items()},
        }
    return {"type": "string"}  # Quantity and friends serialize as strings


def _definition(kind: str, cls) -> Optional[dict]:
    try:
        wire = cls().to_dict()
    except Exception as e:  # noqa: BLE001 - kind omitted, doc still serves
        # a kind with no zero-arg construction silently vanishing from
        # /openapi would be a confusing hole — name the omission
        logger.debug(
            "openapi: kind %s has no zero-arg schema (%s); omitted", kind, e)
        return None
    schema = _schema_for(wire)
    if cls.__doc__:
        schema["description"] = cls.__doc__.strip().splitlines()[0]
    schema["x-kubernetes-group-version-kind"] = [
        {"group": "", "version": "v1", "kind": kind}]
    return schema


def build_openapi(version: str = "v1") -> dict:
    """The full document: one definition per registered kind, one path
    item per resource (list/create at collection, get/put/patch/delete
    at item scope — the verbs the server actually routes)."""
    definitions = {}
    paths = {}
    for kind, cls in sorted(KINDS.items()):
        schema = _definition(kind, cls)
        if schema is None:
            continue
        name = f"io.k8s.api.core.v1.{kind}"
        definitions[name] = schema
        plural = KIND_PLURALS.get(kind)
        if plural is None:
            continue
        ref = {"$ref": f"#/definitions/{name}"}
        namespaced = kind not in CLUSTER_SCOPED_KINDS
        base = (f"/api/v1/namespaces/{{namespace}}/{plural}"
                if namespaced else f"/api/v1/{plural}")
        ns_param = ([{"name": "namespace", "in": "path", "required": True,
                      "type": "string"}] if namespaced else [])
        paths[base] = {
            "get": {"operationId": f"list{kind}",
                    "parameters": ns_param,
                    "responses": {"200": {"description": "OK"}}},
            "post": {"operationId": f"create{kind}",
                     "parameters": ns_param + [
                         {"name": "body", "in": "body", "schema": ref}],
                     "responses": {"201": {"description": "Created",
                                           "schema": ref}}},
        }
        item = f"{base}/{{name}}"
        item_params = ns_param + [{"name": "name", "in": "path",
                                   "required": True, "type": "string"}]
        paths[item] = {
            "get": {"operationId": f"read{kind}", "parameters": item_params,
                    "responses": {"200": {"description": "OK", "schema": ref}}},
            "put": {"operationId": f"replace{kind}",
                    "parameters": item_params + [
                        {"name": "body", "in": "body", "schema": ref}],
                    "responses": {"200": {"description": "OK", "schema": ref}}},
            "patch": {"operationId": f"patch{kind}", "parameters": item_params,
                      "responses": {"200": {"description": "OK",
                                            "schema": ref}}},
            "delete": {"operationId": f"delete{kind}",
                       "parameters": item_params,
                       "responses": {"200": {"description": "OK"}}},
        }
    return {
        "swagger": _SWAGGER_VERSION,
        "info": {"title": "kubernetes-tpu", "version": __version__},
        "paths": paths,
        "definitions": definitions,
    }
