"""The paper's single-cell layer: state and action spaces, the calibrated
end-edge-cloud environment, tabular Q-learning (Algorithm 1), the DQN
with replay (Algorithm 2), the brute-force oracle (Eq. 5-6), the fixed
and SOTA-[36] baselines, the transfer protocol (Fig. 7) and the
orchestrator runtime (Fig. 2, Fig. 4); plus the MLP and replay ring
shared with the fleet agents."""
from repro_torch.core.env import (EXPERIMENTS, THRESHOLDS, EndEdgeCloudEnv,
                                  Scenario)
from repro_torch.core.spaces import SpaceSpec, restricted_actions
from repro_torch.core.qlearning import QLearningAgent, QLearningConfig
from repro_torch.core.dqn import DQNAgent, DQNConfig
from repro_torch.core.bruteforce import (bruteforce_complexity,
                                         bruteforce_optimal)
from repro_torch.core.orchestrator import (IntelligentOrchestrator,
                                           TrainResult, train_agent)
from repro_torch.core.baselines import (fixed_strategy_action,
                                        fixed_strategy_response,
                                        make_sota_agent)
from repro_torch.core.transfer import transfer_experiment
