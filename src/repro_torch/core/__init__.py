"""The paper's training core in the port: the contrastive loss (Eq. 3),
Algorithm-1 GradAccum and the §5.2 rematerialisation policies."""
