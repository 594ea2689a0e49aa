"""Endpoints controller: service selector -> backend pod addresses.

Capability of ``pkg/controller/endpoint/endpoints_controller.go`` (613
LoC): for every Service with a selector, maintain an Endpoints object of
the same name whose subsets hold the pod IPs of Running+ready matching
pods (not-ready pods land in ``notReadyAddresses``), with the service's
target ports.

The Service and its pods come from the informers' caches (the
reference's service and pod listers); the JAX controller GETs the Service
and LISTs the namespace's pods over the wire on every sync, and a sync
follows every event of a selected pod."""

from __future__ import annotations

from ..api import types as api
from ..api.cluster import EndpointAddress, EndpointPort, Endpoints, EndpointSubset
from ..api.meta import ObjectMeta
from ..store.store import AlreadyExistsError, NotFoundError
from .base import Controller


def _pod_ready(pod: api.Pod) -> bool:
    if pod.status.phase != api.RUNNING:
        return False
    for c in pod.status.conditions:
        if c.get("type") == "Ready":
            return c.get("status") == "True"
    return True  # no Ready condition recorded -> assume ready when Running


class EndpointController(Controller):
    name = "endpoint"

    def __init__(self, clientset, informers=None, **kw):
        super().__init__(clientset, informers, **kw)
        self.watch("Service")
        from ..client.informer import Handler

        # updates requeue services matching the OLD labels too, so a pod
        # relabeled away from a selector is removed from its endpoints
        self.informers.informer("Pod").add_handler(Handler(
            on_add=self._pod_event,
            on_update=lambda old, new: (self._pod_event(old), self._pod_event(new)),
            on_delete=self._pod_event,
        ))

    def _pod_event(self, pod: api.Pod) -> None:
        for svc in self.informer("Service").list():
            if svc.meta.namespace != pod.meta.namespace or not svc.selector:
                continue
            if all(pod.meta.labels.get(k) == v for k, v in svc.selector.items()):
                self.queue.add(svc.meta.key)

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        svc = self.informer("Service").get(key)
        if svc is None:
            # service gone: remove its endpoints
            try:
                self.clientset.endpoints.delete(name, namespace)
            except NotFoundError:
                pass
            return
        if not svc.selector:
            return  # manual endpoints (headless external): hands off

        ready: list[EndpointAddress] = []
        not_ready: list[EndpointAddress] = []
        for pod in self.informer("Pod").list():
            if pod.meta.namespace != namespace or pod.status.phase in (api.SUCCEEDED,
                                                                        api.FAILED):
                continue
            if not all(pod.meta.labels.get(k) == v for k, v in svc.selector.items()):
                continue
            if not pod.status.pod_ip:
                continue
            addr = EndpointAddress(
                ip=pod.status.pod_ip,
                node_name=pod.spec.node_name,
                target_pod=pod.meta.key,
            )
            (ready if _pod_ready(pod) else not_ready).append(addr)

        ports = [
            EndpointPort(name=p.name, port=(p.target_port or p.port), protocol=p.protocol)
            for p in svc.ports
        ]
        subsets = []
        if ready or not_ready:
            subsets = [EndpointSubset(
                addresses=sorted(ready, key=lambda a: a.ip),
                not_ready_addresses=sorted(not_ready, key=lambda a: a.ip),
                ports=ports,
            )]

        desired = Endpoints(
            meta=ObjectMeta(name=name, namespace=namespace, labels=dict(svc.meta.labels)),
            subsets=subsets,
        )
        try:
            cur = self.clientset.endpoints.get(name, namespace)
        except NotFoundError:
            try:
                self.clientset.endpoints.create(desired)
            except AlreadyExistsError:
                pass
            return
        if [s.to_dict() for s in cur.subsets] != [s.to_dict() for s in subsets]:
            def _update(obj: Endpoints) -> Endpoints:
                obj.subsets = subsets
                return obj

            self.clientset.endpoints.guaranteed_update(name, _update, namespace)
