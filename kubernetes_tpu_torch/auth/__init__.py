"""Authentication, authorization and audit: the filters of the
apiserver's chain (reference ``pkg/kubeapiserver/authenticator``,
``authorizer`` and ``apiserver/pkg/audit``).  Pure Python, no ``torch``:
none of it is device work."""

from .audit import (
    AuditEvent,
    AuditPolicy,
    Auditor,
    LogBackend,
    MemoryBackend,
    WebhookBackend,
)
from .audit import PolicyRule as AuditPolicyRule
from .authn import (
    BootstrapTokenAuthenticator,
    ANONYMOUS,
    Authenticator,
    OIDCAuthenticator,
    RequestHeaderAuthenticator,
    ServiceAccountTokenAuthenticator,
    ServiceAccountTokenMinter,
    TokenFileAuthenticator,
    UnionAuthenticator,
    UserInfo,
    WebhookTokenAuthenticator,
    X509CertificateAuthenticator,
)
from .authz import (
    ALLOW,
    DENY,
    NO_OPINION,
    ABACAuthorizer,
    AlwaysAllow,
    AuthenticatedOrDiscovery,
    AuthzAttributes,
    Authorizer,
    BootstrapPolicyAuthorizer,
    NodeAuthorizer,
    RBACAuthorizer,
    UnionAuthorizer,
    WebhookAuthorizer,
)
