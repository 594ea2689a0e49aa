"""CRD registrar: establish custom kinds from CustomResourceDefinitions.

The controller half of ``apiextensions-apiserver``'s establishing
controller: watch CRD objects, register the named kind into the live
type registry (making it wire-addressable, informable, GC-visible, and
kubectl-visible), mark the CRD Established, and unregister on delete."""

from __future__ import annotations

import logging
import threading

from ..api.crd import (
    CustomResourceDefinition,
    register_custom_kind,
    unregister_custom_kind,
)
from ..store.store import NotFoundError
from .base import Controller

logger = logging.getLogger("kubernetes_tpu_torch.controllers.crd")


class CRDRegistrar(Controller):
    name = "crd-registrar"

    def __init__(self, clientset, informers=None, **kw):
        super().__init__(clientset, informers, **kw)
        self.watch("CustomResourceDefinition")
        # name -> established kind, for unregistration on delete.  Guarded
        # by _mu: two workers syncing CRDs that name the same kind must not
        # both pass the claimant check (ktpu-analyze RL303).
        self._mu = threading.Lock()
        self._established: dict[str, str] = {}

    def sync(self, key: str) -> None:
        crd = self.informer("CustomResourceDefinition").get(key)
        if crd is None:
            with self._mu:
                kind = self._established.pop(key, None)
                # only the CRD that claimed the kind may unregister it — a
                # duplicate CRD naming the same kind must not pull the rug
                # out from under the claimant on its own deletion.  The
                # unregister itself stays under _mu: outside it, a worker
                # re-claiming the kind between the check and the call would
                # get its fresh registration torn down (TOCTOU).
                if kind is not None and kind not in self._established.values():
                    unregister_custom_kind(kind)
                    logger.info("crd %s deleted: kind %s unregistered", key, kind)
            return
        with self._mu:
            claimant = next(
                (n for n, k in self._established.items() if k == crd.kind_name), None
            )
            if claimant is not None and claimant != key:
                return  # another CRD already owns this kind: never established
            cls = register_custom_kind(crd)
            if cls is None:
                return  # name collision with a built-in: never established
            self._established[key] = crd.kind_name
        if not crd.established:
            def _mark(cur: CustomResourceDefinition) -> CustomResourceDefinition:
                cur.established = True
                return cur

            try:
                self.clientset.customresourcedefinitions.guaranteed_update(
                    crd.meta.name, _mark
                )
            except NotFoundError:
                pass
