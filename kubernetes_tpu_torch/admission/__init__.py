"""Admission control (``apiserver/pkg/admission`` and
``plugin/pkg/admission/*``): the mutating/validating plugin chain on the
write path, plus the quota evaluator library (``pkg/quota``).
``default_chain()`` is the JAX package's chain, plugin for plugin and in
its order; the apiserver serves an ``AdmittedStore`` over it unless
started with ``--disable-admission``."""

from .framework import (
    CREATE,
    DELETE,
    UPDATE,
    AdmissionChain,
    AdmissionDenied,
    AdmissionPlugin,
    AdmittedStore,
    Attributes,
)
from .plugins import (
    IMMORTAL_NAMESPACES,
    PodPrepareForCreate,
    DefaultTolerationSeconds,
    LimitPodHardAntiAffinityTopology,
    LimitRanger,
    NamespaceLifecycle,
    Priority,
    ResourceQuota,
    ServiceAccount,
    default_chain,
)
from .plugins_ext import (
    AlwaysAdmit,
    AlwaysDeny,
    DenyEscalatingExec,
    Initializers,
    NamespaceAutoProvision,
    OwnerReferencesPermissionEnforcement,
    PersistentVolumeLabel,
    SecurityContextDeny,
    AlwaysPullImages,
    DefaultStorageClass,
    GenericAdmissionWebhook,
    ImagePolicyWebhook,
    NetworkPolicyValidation,
    NodeRestriction,
    PodNodeSelector,
    PodPreset,
    PodSecurityPolicyPlugin,
    ServiceIPAllocator,
)
from . import quota
