// Line-search rollout kernels of the batched AL-iLQR solver (K3, K4) for
// the hand-written device models of the library's problems: the rollout
// body of sl_rollout.cuh (K3, the score policy, replaces the TPU kernel
// iterativelqr_tpu/ops/sl_forward_kernel.py::_score_kernel; K4, the
// re-roll policy, ::_reroll_kernel) instantiated for each model of
// sl_model_*.cuh in f32 and f64.  ops/sl_forward_kernel.py's registry picks
// these for a spec made of a registered model's own functions; any other
// stage-uniform spec gets a generated model (ops/device_functions.py) in a
// translation unit of its own that includes the same body.
//
// The hand-written models take no per-step parameters (NW = 0) and ignore
// the w argument of their device functions.

#include "sl_model_acrobot.cuh"
#include "sl_model_car.cuh"
#include "sl_model_cartpole.cuh"
#include "sl_model_particle.cuh"
#include "sl_model_pendulum.cuh"
#include "sl_model_quadrotor.cuh"
#include "sl_rollout.cuh"

SL_ENTRIES(acrobot_f32, sl_models::Acrobot, float)
SL_ENTRIES(acrobot_f64, sl_models::Acrobot, double)
SL_ENTRIES(acrobot_nc0_f32, sl_models::AcrobotNc0, float)
SL_ENTRIES(acrobot_nc0_f64, sl_models::AcrobotNc0, double)
SL_ENTRIES(car_f32, sl_models::Car, float)
SL_ENTRIES(car_f64, sl_models::Car, double)
SL_ENTRIES(quadrotor_f32, sl_models::Quadrotor, float)
SL_ENTRIES(quadrotor_f64, sl_models::Quadrotor, double)
SL_ENTRIES(particle_f32, sl_models::Particle, float)
SL_ENTRIES(particle_f64, sl_models::Particle, double)
SL_ENTRIES(pendulum_f32, sl_models::Pendulum, float)
SL_ENTRIES(pendulum_f64, sl_models::Pendulum, double)
SL_ENTRIES(cartpole_f32, sl_models::Cartpole, float)
SL_ENTRIES(cartpole_f64, sl_models::Cartpole, double)
