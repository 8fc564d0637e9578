"""Domain-specific BatchNorm for UDA testing (port of
``reid_gan_tpu/models/dsbn.py``; parity: CC/clustercontrast/models/
dsbn.py:6-79).

As in the JAX package, DSBN is a transform of variables trees
(``{"params", "batch_stats"}``, the flax layout a msgpack checkpoint holds),
not of the model: ``convert_dsbn`` keeps one copy of the variables per
domain under ``{"domains": {"d0": ..., "d1": ...}}`` (dict keys, which a
msgpack file round-trips), ``select_domain`` and ``update_domain`` read and
replace one domain's copy, and ``convert_bn`` folds the checkpoint back to
plain variables: the target domain ``d1``, or the source ``d0``. The model
always sees plain BatchNorm variables.
"""


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree


def convert_dsbn(variables, num_domains=2):
    """variables → ``{"domains": {"d0": variables, "d1": variables, ...}}``,
    one copy of the tree per domain."""
    return {"domains": {f"d{i}": _copy(variables) for i in range(num_domains)}}


def select_domain(dsbn_variables, domain):
    """The variables of domain ``domain`` (1 is the target, dsbn.py
    convert)."""
    return dsbn_variables["domains"][f"d{domain}"]


def update_domain(dsbn_variables, domain, variables):
    """A new DSBN tree with domain ``domain``'s variables replaced."""
    doms = dict(dsbn_variables["domains"])
    doms[f"d{domain}"] = variables
    return {"domains": doms}


def convert_bn(dsbn_variables, use_target=True):
    """The plain variables of the target domain ``d1``, or with
    ``use_target=False`` of the source ``d0`` (dsbn.py:45-79)."""
    return dsbn_variables["domains"]["d1" if use_target else "d0"]
