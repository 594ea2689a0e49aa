"""Service dataplane (SURVEY.md L7: kube-proxy, ``pkg/proxy``)."""

from .proxier import EndpointInfo, Proxier, Rule, ServicePortName
from .hollow import HollowProxy, HollowProxyFleet
from .healthcheck import ProxierHealthServer, ServiceHealthServer
from .userspace import UserspaceProxier
