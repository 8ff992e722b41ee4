"""Security: JWT tokens, password hashing, user management.

Reference: sitewhere-microservice security/TokenManagement.java (JWT),
service-user-management (users/authorities, BCrypt), JwtServerInterceptor /
TenantTokenServerInterceptor metadata propagation.
"""

from sitewhere_tpu_torch.security.auth import hash_password, verify_password
from sitewhere_tpu_torch.security.tokens import InvalidTokenError, TokenManagement
from sitewhere_tpu_torch.security.users import UserManagement

__all__ = ["InvalidTokenError", "TokenManagement", "UserManagement",
           "hash_password", "verify_password"]
