from repro_torch.sharding.rules import (ShardingRules, default_act_rules,
                                        default_weight_rules, make_rules,
                                        spec_tree_pspecs,
                                        spec_tree_shardings, use_sharding)

__all__ = ["ShardingRules", "default_act_rules", "default_weight_rules",
           "make_rules", "spec_tree_pspecs", "spec_tree_shardings",
           "use_sharding"]
